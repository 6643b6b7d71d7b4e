"""step_mfu: the whole denoise step's share of the card's bf16 peak, %.

The model's operations of one CFG step (benchmark/work.py: the linears at
2*rows*N*K, attention at 4*D a (query, key) pair and head, dense or the
sliding-tile window, valid text keys only; the same count for every
configuration, whatever kernels run) over the traced steps' mean time
(host marks at each synchronized step end) times 989 TFLOP/s. Moves
step_s; it bounds every kernel's roofline share of the step.
"""
from benchmark.work import patch_grid, step_operations
from benchmark.yardstick import PEAK_FLOPS


def read(run):
    span = run.span
    if not span or span["units"] < 1 or "text_valid" not in run.shapes:
        return None
    grid = patch_grid(run.cfg, run.traffic)
    lt = run.cfg["text"]["text_len"]
    ops = step_operations(run.cfg, grid, lt, run.shapes["text_valid"])
    step = (span["t1"] - span["t0"]) / 1e9 / span["units"]
    return 100.0 * ops / (step * PEAK_FLOPS)
