"""Time the VAE decoder's heavy causal convs on the card: F.conv3d, K3 and
the temporal-reuse kernel B11 (JAX counterpart: scripts/conv_probe.py).

    python -m hunyuanvideo_efficiency_tpu_torch.probes.conv_probe [--reps N]

First a numerics check on a small input: `causal_conv3d(impl="cuda")` (K3)
and B11 on the same padded input against `impl="3d"` (F.conv3d), max
relative error 2e-2. Then, at the decoder tile's three heavy stages (B = 1,
bf16), the milliseconds and TFLOP/s of each, the replicate pad included as
in causal_conv3d: the minimum over N timed calls after one warm-up, CUDA
events. JAX's h_block sweep is a TPU tiling knob and is not carried over.
Needs a CUDA device.
"""
import argparse

import torch

from ..ops.conv3d import causal_conv3d, replicate_pad
from ..ops.conv3d_cuda import conv3d_stride1_v2

# (T, H, W, Cin, Cout): the decoder tile's heavy stride-1 stages, B = 1
SHAPES = ((61, 256, 256, 128, 128), (31, 128, 128, 256, 256),
          (16, 64, 64, 512, 512))


def min_ms(fn, reps):
    """Least time of one call of fn over `reps` calls after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return min(times)


def v2_conv(x, kernel, bias=None):
    """B11 behind causal_conv3d's padding: the edge-replicate (2, 0) on T
    and (1, 1) on H and W, then conv3d_stride1_v2."""
    return conv3d_stride1_v2(replicate_pad(x, (2, 0), (1, 1), (1, 1)),
                             kernel, bias)


def numerics_check(dev):
    """K3 and B11 against F.conv3d on [1, 5, 16, 18, 128] bf16; returns
    the max relative errors."""
    g = torch.Generator(dev).manual_seed(7)
    x = torch.randn(1, 5, 16, 18, 128, generator=g, device=dev).bfloat16()
    k = (torch.randn(3, 3, 3, 128, 128, generator=g, device=dev)
         * 0.05).bfloat16()
    ref = causal_conv3d(x, k, impl="3d").float()
    errs = {}
    for label, out in (("cuda", causal_conv3d(x, k, impl="cuda")),
                       ("v2", v2_conv(x, k))):
        errs[label] = ((out.float() - ref).abs().max()
                       / (ref.abs().max() + 1e-6)).item()
        print(f"{label} vs 3d on the card: max rel err {errs[label]:.2e}",
              flush=True)
    if max(errs.values()) > 2e-2:
        raise AssertionError(f"conv numerics mismatch on the card: {errs}")
    return errs


def main(reps=3, shapes=SHAPES):
    """Run the probe; returns one dict per shape with each form's ms."""
    if not torch.cuda.is_available():
        raise SystemExit("the conv probe needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    numerics_check(dev)
    g = torch.Generator(dev).manual_seed(0)
    results = []
    for t, h, w, cin, cout in shapes:
        x = torch.randn(1, t, h, w, cin, generator=g, device=dev).bfloat16()
        k = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
             * 0.02).bfloat16()
        flops = 2.0 * 27 * cin * cout * t * h * w
        row = dict(shape=[1, t, h, w, cin], cout=cout)
        for label, fn in (
                ("f_conv3d", lambda: causal_conv3d(x, k, impl="3d")),
                ("k3", lambda: causal_conv3d(x, k, impl="cuda")),
                ("v2", lambda: v2_conv(x, k))):
            ms = min_ms(fn, reps)
            row[f"{label}_ms"] = ms
            print(f"{label:<8}: {ms:9.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s "
                  f"(shape {(1, t, h, w, cin)} k(3, 3, 3)x{cin}->{cout})",
                  flush=True)
        results.append(row)
        del x, k
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    main(ap.parse_args().reps)
