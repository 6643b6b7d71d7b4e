"""k1_roofline: K1's share of its roofline in the dense step, %.

Sum of K1's bounds over the sum of its device time in the traced steps.
K1 is csrc/flash_attention.cu's flash_fwd_kernel<T, D, RUNNING=false,
LSE=false> (with flash_combine_kernel<T, D, false> where a call splits its
keys); its instances must equal the launches its wrapper `flash_static`
counted. Each launch of the dense step is one block's joint attention,
[B, S, H, D] with S = image + text tokens, over the image keys and each
sample's valid text keys: 4*D*H*S*sum_b(keys_b) operations at 989 TFLOP/s
against q, k, v and the output read or written once (bf16) at 3.35 TB/s.
Moves step_s. Nothing to read outside the dense configuration.
"""
import re

from benchmark.work import patch_grid
from benchmark.yardstick import bound

K1 = re.compile(r"flash_fwd_kernel<[^>]*, (false|\(bool\)0), "
                r"(false|\(bool\)0)>")
K1_MERGE = re.compile(r"flash_combine_kernel<[^>]*, (false|\(bool\)0)>")

# the program's wrapper whose LAUNCHES the trace is tied to
COUNTERS = {"flash_static": "hunyuanvideo_efficiency_tpu_torch.ops."
                            "flash_attention:flash_static"}


def launch_bound_ms(cfg, n_img, lt, valid):
    d = cfg["dit"]
    hh = d["heads_num"]
    dd = d["hidden_size"] // hh
    s = n_img + lt
    ops = 4.0 * dd * hh * s * sum(n_img + v for v in valid)
    nbytes = 4 * len(valid) * s * hh * dd * 2
    return bound(ops, nbytes)[0]


def read(run):
    span = run.span
    if not span or run.cfg["sta"] is not None or run.trace is None:
        return None
    t0, t1 = span["t0"], span["t1"]
    n = run.trace.count(lambda k: K1.search(k), t0, t1)
    if n == 0:
        return None
    want = span["launches"]["flash_static"]
    if n != want:
        raise RuntimeError(f"k1_roofline: {n} K1 kernels in the trace, "
                           f"{want} launches counted")
    secs = run.trace.seconds(lambda k: bool(K1.search(k) or
                                            K1_MERGE.search(k)), t0, t1)
    grid = patch_grid(run.cfg, run.traffic)
    n_img = grid[0] * grid[1] * grid[2]
    b_ms = launch_bound_ms(run.cfg, n_img, run.cfg["text"]["text_len"],
                           run.shapes["text_valid"])
    return 100.0 * n * b_ms / 1e3 / secs
