"""Time the VAE decoder's heavy causal convs on the card: F.conv3d, K3 and
the temporal-reuse kernel B11 (JAX counterpart: scripts/conv_probe.py).

    python -m hunyuanvideo_efficiency_tpu_torch.probes.conv_probe [--reps N]

First a numerics check on a small input: `causal_conv3d(impl="cuda")` (K3)
and B11 on the same padded input against `impl="3d"` (F.conv3d), max
relative error 2e-2. Then, at the decoder tile's three heavy stages (B = 1,
bf16), the milliseconds and TFLOP/s of each, the replicate pad included as
in causal_conv3d: the minimum over N timed calls after one warm-up, CUDA
events. JAX's h_block sweep is a TPU tiling knob and is not carried over.
Needs a CUDA device. `decode_k3_shapes` lists the K3 launches of one
tiled decode by shape, from the decoder run on meta tensors (no device).
"""
import argparse
import collections

import torch

from ..models.vae import AutoencoderKLCausal3D
from ..models.vae_config import load_vae_config
from ..ops import conv3d as conv3d_mod
from ..ops.conv3d import causal_conv3d, replicate_pad
from ..ops.conv3d_cuda import conv3d_stride1_v2

# (T, H, W, Cin, Cout): the decoder tile's heavy stride-1 stages, B = 1
SHAPES = ((61, 256, 256, 128, 128), (31, 128, 128, 256, 256),
          (16, 64, 64, 512, 512))


def decode_k3_shapes(height, width, frames, vae="884-16c-hy"):
    """{(B, T, H, W, Cin, Cout): launches} of K3 in one tiled VAE decode of
    a height x width x frames video (B = 1), as the sampler decodes it.
    The decoder runs on meta tensors (shapes only: no data, no device) with
    causal_conv3d's K3 call replaced by a recorder for the duration."""
    seen = collections.Counter()

    def record(xp, kernel, bias=None):
        b, tp, hp, wp, cin = xp.shape
        shape = (b, tp - 2, hp - 2, wp - 2, cin, kernel.shape[4])
        seen[shape] += 1
        return xp.new_empty(shape[:4] + shape[5:])

    cfg = load_vae_config(vae)
    model = AutoencoderKLCausal3D(cfg, device="meta", dtype=torch.float16)
    model.enable_tiling(True)
    z = torch.empty(1, cfg.latent_channels,
                    (frames - 1) // cfg.time_compression_ratio + 1,
                    height // cfg.spatial_compression_ratio,
                    width // cfg.spatial_compression_ratio, device="meta",
                    dtype=torch.float16)
    real = conv3d_mod.conv3d_stride1
    conv3d_mod.conv3d_stride1 = record
    try:
        model.decode(z)
    finally:
        conv3d_mod.conv3d_stride1 = real
    return dict(sorted(seen.items()))


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
