"""adaln_ms.step: the DiT's adaLN glue, device ms a step: the `dit.adaln`
spans of models/dit.py (each modulate(layer_norm(x)) and each gated
residual x + apply_gate(y): 8 a double block, 2 a single block, 1 in the
final layer) in the traced steps, over the steps. Moves step_s."""
from benchmark.spans import step_total


def read(run):
    return step_total(run, "adaln_ms.step", "dit.adaln")
