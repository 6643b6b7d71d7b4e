"""sta_roofline: B4q's share of its roofline in the STA int8 step, %.

Sum of B4q's bounds over the device time of B4q and its pre-pass in the
traced steps. B4q is csrc/sta_direct.cu's sta_direct_kernel<T, D,
QUANT=true, RING=false>, its pre-pass tile_codes_kernel; its instances must
equal the launches its wrapper `sta_direct_int8` counted. A launch is one
STA block's image queries [B, S_img, H, D]: Q.K^T over the valid window
pairs in int8 at 1,979 TOP/s, P.V over them and both products over the
valid text keys at 989 TFLOP/s (benchmark/work.py counts the pairs),
against the image q, k, v, the text k, v and the output, each read or
written once (bf16), at 3.35 TB/s. Moves step_s.
"""
import re

from benchmark.work import patch_grid, sta_image_pairs
from benchmark.yardstick import bound

B4Q = re.compile(r"sta_direct_kernel<[^>]*, (true|\(bool\)1), "
                 r"(false|\(bool\)0)>")
PRE = re.compile(r"tile_codes_kernel")

# the program's wrapper whose LAUNCHES the trace is tied to
COUNTERS = {"sta_direct_int8": "hunyuanvideo_efficiency_tpu_torch.ops."
                               "sta:sta_direct_int8"}


def launch_bound_ms(cfg, grid, lt, valid):
    d, sta = cfg["dit"], cfg["sta"]
    hh = d["heads_num"]
    dd = d["hidden_size"] // hh
    n_img = grid[0] * grid[1] * grid[2]
    pairs = sta_image_pairs(grid, sta["tile"], sta["window"])
    b = len(valid)
    int8_ops = 2.0 * dd * hh * b * pairs
    flops = 2.0 * dd * hh * b * pairs + 4.0 * dd * hh * n_img * sum(valid)
    nbytes = (4 * n_img + 2 * lt) * b * hh * dd * 2
    return bound(flops, nbytes, int8_ops)[0]


def read(run):
    span = run.span
    if not span or run.cfg["sta"] is None or run.trace is None:
        return None
    t0, t1 = span["t0"], span["t1"]
    n = run.trace.count(lambda k: B4Q.search(k), t0, t1)
    if n == 0:
        return None
    want = span["launches"]["sta_direct_int8"]
    if n != want:
        raise RuntimeError(f"sta_roofline: {n} B4q kernels in the trace, "
                           f"{want} launches counted")
    secs = run.trace.seconds(lambda k: bool(B4Q.search(k) or PRE.search(k)),
                             t0, t1)
    grid = patch_grid(run.cfg, run.traffic)
    b_ms = launch_bound_ms(run.cfg, grid, run.cfg["text"]["text_len"],
                           run.shapes["text_valid"])
    return 100.0 * n * b_ms / 1e3 / secs
