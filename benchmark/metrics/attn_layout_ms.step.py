"""attn_layout_ms.step: the joint attention's layout work, device ms a
step: the `dit.attention` spans of models/dit.py (each block's joint
attention with its concatenations, splits and casts) less their
children, the attention kernel wrappers' own spans (flash_static,
sta_direct_int8, ...), in the traced steps, over the steps. Moves
step_s."""
from benchmark.spans import step_total


def read(run):
    return step_total(run, "attn_layout_ms.step", "dit.attention",
                      field="self_device_ms")
