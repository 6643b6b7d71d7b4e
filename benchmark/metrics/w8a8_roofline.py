"""w8a8_roofline: B9's share of its roofline in the int8 step, %.

Sum of B9's bounds over the device time of B9 (csrc/w8a8_linear.cu's
w8a8_gemm_kernel and its quant_rows_kernel pre-pass) in the traced steps;
its GEMM instances must equal the launches its wrapper `w8a8_linear`
counted, and those the block linears' calls the traced steps make (10 a
double block, 5 a single block). Each call's bound from its shape (rows M,
N, K): 2*M*N*K int8 operations at 1,979 TOP/s against x (bf16), W (int8)
and y (bf16) read or written once at 3.35 TB/s. Moves step_s.
"""
import re

from benchmark.work import linears, patch_grid
from benchmark.yardstick import bound

GEMM = re.compile(r"w8a8_gemm_kernel")
B9 = re.compile(r"w8a8|quant_rows_kernel")

# the program's wrapper whose LAUNCHES the trace is tied to
COUNTERS = {"w8a8_linear": "hunyuanvideo_efficiency_tpu_torch.ops."
                           "int8_matmul:w8a8_linear"}


def block_calls(cfg, n_img, lt, batch):
    """(M, N, K) of the W8A8 calls of one forward: the double and single
    blocks' linears, the single block's fused linears as two calls each."""
    d = cfg["dit"]
    ls = linears(cfg, n_img, lt, batch)
    first = 10 + 5 * d["refiner_depth"]
    n_double = 10 * d["mm_double_blocks_depth"]
    return ls[first:first + n_double + 5 * d["mm_single_blocks_depth"]]


def read(run):
    span = run.span
    if not span or not run.cfg["use_int8"] or run.trace is None:
        return None
    t0, t1 = span["t0"], span["t1"]
    n = run.trace.count(lambda k: GEMM.search(k), t0, t1)
    if n == 0:
        return None
    grid = patch_grid(run.cfg, run.traffic)
    calls = block_calls(run.cfg, grid[0] * grid[1] * grid[2],
                        run.cfg["text"]["text_len"],
                        len(run.shapes["text_valid"]))
    want = span["launches"]["w8a8_linear"]
    if not n == want == len(calls) * span["units"]:
        raise RuntimeError(f"w8a8_roofline: {n} B9 GEMMs in the trace, "
                           f"{want} launches counted, {len(calls)} calls a "
                           f"step for {span['units']} steps")
    step_ms = sum(bound(0.0, m * k * 2 + n_ * k + m * n_ * 2,
                        2.0 * m * n_ * k)[0] for m, n_, k in calls)
    secs = run.trace.seconds(lambda k: bool(B9.search(k)), t0, t1)
    return 100.0 * step_ms * span["units"] / 1e3 / secs
