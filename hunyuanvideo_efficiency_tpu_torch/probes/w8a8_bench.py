"""Time the W8A8 linear B9 at every shape the int8 DiT gives it.

    python -m hunyuanvideo_efficiency_tpu_torch.probes.w8a8_bench [--reps N]

One line a shape class of the int8 main path at 256x448x33f under CFG
(8,064 image rows, 512 text rows, 8,576 single-block rows, the 2-row
modulation matvecs), each with its calls a denoise step (20 double and 40
single blocks), on random bf16 rows and int8 weights from a fixed seed;
the single block's linear1 column slices and linear2 K slices are views of
the fused weight, as in the DiT. For each: the schedule `plan_w8a8` picks,
the kernel against `w8a8_linear_plain` (equal without an activation, max
relative error 1e-2 with one), its device time (`graph_ms`: --reps calls
captured in one CUDA graph and replayed, so that the host's launch cost,
which exceeds a matvec's device time, is left out) and its eager time
(back-to-back calls, host included), the pre-pass alone (`w8a8_prepass`),
`torch._int_mm` on the same codes (rows padded to 32 for the matvec), and
the bound: 2*M*N*K at 1,979 TOP/s against the bytes of x, W, y, scales
and bias at 3.35 TB/s. Then the step's sum of device times against the
sum of bounds. Exits non-zero on a mismatch or without a CUDA device.
"""
import argparse
import json

import torch

from ..ops.int8_matmul import (_sm_count, plan_w8a8, quantize_rows,
                               w8a8_linear, w8a8_linear_plain, w8a8_prepass)
from ..ops.quantization import quantize_tensor_int8

PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
H, MLP = 3072, 12288
IMG, TXT, B = 4032, 256, 2

# (name, rows, (weight rows, weight cols), (column slice), (K slice), act,
# calls a step)
SHAPES = (
    ("double img qkv", B * IMG, (3 * H, H), None, None, None, 20),
    ("double img proj", B * IMG, (H, H), None, None, None, 20),
    ("double img fc1", B * IMG, (MLP, H), None, None, "gelu_tanh", 20),
    ("double img fc2", B * IMG, (H, MLP), None, None, None, 20),
    ("double txt qkv", B * TXT, (3 * H, H), None, None, None, 20),
    ("double txt proj", B * TXT, (H, H), None, None, None, 20),
    ("double txt fc1", B * TXT, (MLP, H), None, None, "gelu_tanh", 20),
    ("double txt fc2", B * TXT, (H, MLP), None, None, None, 20),
    ("double modulation", B, (6 * H, H), None, None, None, 40),
    ("single linear1 qkv", B * (IMG + TXT), (3 * H + MLP, H),
     (0, 3 * H), None, None, 40),
    ("single linear1 mlp", B * (IMG + TXT), (3 * H + MLP, H),
     (3 * H, 3 * H + MLP), None, "gelu_tanh", 40),
    ("single linear2 attn", B * (IMG + TXT), (H, H + MLP), None, (0, H),
     None, 40),
    ("single linear2 mlp", B * (IMG + TXT), (H, H + MLP), None,
     (H, H + MLP), None, 40),
    ("single modulation", B, (3 * H, H), None, None, None, 40),
)


def cuda_ms(fn, reps):
    """Mean time of one call of fn over `reps` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device time of one call of fn: `reps` calls captured in one
    CUDA graph after a warm-up, the graph replayed once to warm it and
    once timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def bound_ms(m, n, k):
    nbytes = m * k * 2 + n * k + m * n * 2 + n * 4 + n * 2
    return max(2 * m * n * k / PEAK_INT8, nbytes / PEAK_BYTES) * 1e3


def measure(dev, g, name, m, wshape, cols, ks, act, reps):
    w8, so = quantize_tensor_int8(torch.randn(*wshape, generator=g,
                                              device=dev))
    bias = torch.randn(wshape[0], generator=g, device=dev).bfloat16()
    if cols is not None:
        w8, so, bias = (v[cols[0]:cols[1]] for v in (w8, so, bias))
    if ks is not None:
        w8 = w8[:, ks[0]:ks[1]]
    n, k = w8.shape
    x = torch.randn(m, k, generator=g, device=dev).bfloat16()
    out = w8a8_linear(x, w8, so, bias, act)
    ref = w8a8_linear_plain(x, w8, so, bias, act)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs().max().item()
    rel = diff / max(ref.float().abs().max().item(), 1e-30)
    ok = diff == 0.0 if act is None else rel <= 1e-2
    del out, ref
    ms = graph_ms(lambda: w8a8_linear(x, w8, so, bias, act), reps)
    eager_ms = cuda_ms(lambda: w8a8_linear(x, w8, so, bias, act), reps)
    quant_ms = graph_ms(lambda: w8a8_prepass(x), reps)
    xq = quantize_rows(x)[0]
    if m < 32:
        xq = torch.nn.functional.pad(xq, (0, 0, 0, 32 - m))
    wt = w8.contiguous().t()
    lib_ms = graph_ms(lambda: torch._int_mm(xq, wt), reps)
    plan = plan_w8a8(m, n, k, _sm_count(x.device))
    return dict(name=name, shape=f"[{m},{k}]->{n}", act=act,
                plan=f"{plan.bm}x{plan.bn} split {plan.split} grid "
                     f"{plan.grid}",
                max_abs_err=diff, ok=ok, kernel_ms=ms, eager_ms=eager_ms,
                quant_ms=quant_ms,
                library_ms=lib_ms, bound_ms=bound_ms(m, n, k),
                tops=2 * m * n * k / ms / 1e9)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the W8A8 bench needs a CUDA device")
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(3)
    rows, step_ms, step_bound = [], 0.0, 0.0
    for name, m, wshape, cols, ks, act, calls in SHAPES:
        r = measure(dev, g, name, m, wshape, cols, ks, act, args.reps)
        r["calls"] = calls
        print("[w8a8] " + " ".join(f"{k}={v}" for k, v in r.items()),
              flush=True)
        step_ms += calls * r["kernel_ms"]
        step_bound += calls * r["bound_ms"]
        rows.append(r)
        torch.cuda.empty_cache()
    print(f"[w8a8_step] kernel_ms={step_ms} bound_ms={step_bound} "
          f"share={step_bound / step_ms}", flush=True)
    print(json.dumps(dict(rows=rows, step_ms=step_ms,
                          step_bound_ms=step_bound)))
    if not all(r["ok"] for r in rows):
        raise SystemExit("w8a8: a kernel disagrees with its plain version")
    return rows


if __name__ == "__main__":
    main()
