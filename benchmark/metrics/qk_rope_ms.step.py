"""qk_rope_ms.step: the DiT's QK-RMSNorm + RoPE, device ms a step: the
`dit.qk_rope` spans of models/dit.py (the norm and rotary statements of
both streams of each double block and of each single block, one a block
and forward) in the traced steps, start to end on the card, over the
steps. Moves step_s."""
from benchmark.spans import step_total


def read(run):
    return step_total(run, "qk_rope_ms.step", "dit.qk_rope")
