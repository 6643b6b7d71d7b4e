"""Time one joint STA attention layer on the card (JAX counterpart:
scripts/sta_kernel_bench.py).

    python -m hunyuanvideo_efficiency_tpu_torch.probes.sta_kernel_bench \
        H W F [--dense] [--no-int8] [--ring]

H x W pixels and F frames give the (T, H/16, W/16) patch grid of the DiT,
T = (F - 1)/4 + 1. One layer at B = 1, 24 heads x 128 and 256 text keys,
bf16 inputs N(0, 1)/d^0.25 from a fixed seed: `sta_joint_attention` with
tile (4, 8, 8), window (3, 3, 3) and the static bound (int8 Q.K^T unless
--no-int8; --ring takes the ring kernel where its gate admits the call,
which excludes int8), or with --dense the dense flash attention of
`joint_attention`. Prints the least milliseconds of 5 timed calls after a
warm-up (CUDA events), the kernel that ran, and TFLOP/s over the work the
layer needs: 4*D per valid query-key pair, the image queries over their
window tiles and the text, the text queries over all keys. JAX's --rotate*
and --probe= are TPU-only and are not carried over. Needs a CUDA device.
"""
import argparse

import torch

from ..ops import sta
from ..ops.attention import joint_attention
from ..ops.flash_attention import flash_running, flash_static
from .conv_probe import min_ms

TILE, WINDOW = (4, 8, 8), (3, 3, 3)
HEADS, HEAD_DIM, TEXT_KEYS = 24, 128, 256
KERNELS = (sta.sta_ring, sta.sta_direct, sta.sta_direct_int8, flash_static,
           flash_running)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("height", type=int)
    ap.add_argument("width", type=int)
    ap.add_argument("frames", type=int)
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--no-int8", dest="int8", action="store_false")
    ap.add_argument("--ring", action="store_true")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the bench; returns its numbers as a dict."""
    args = parse(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the STA bench needs a CUDA device")
    dev = torch.device("cuda")
    grid = ((args.frames - 1) // 4 + 1, args.height // 16, args.width // 16)
    s = grid[0] * grid[1] * grid[2]
    b, h, d, lt = 1, HEADS, HEAD_DIM, TEXT_KEYS
    g = torch.Generator(dev).manual_seed(0)
    img, txt = ([(torch.randn(b, n, h, d, generator=g, device=dev)
                  / d ** 0.25).bfloat16() for _ in range(3)]
                for n in (s, lt))
    if args.dense:
        label = "dense flash"

        def fn():
            return joint_attention(*img, *txt, None, mode="flash")

        pairs = (s + lt) ** 2
    else:
        label = (f"sta{'_int8' if args.int8 else ''}"
                 f"{'_ring' if args.ring else ''}")

        def fn():
            return sta.sta_joint_attention(
                *img, *txt, None, grid=grid, tile=TILE, window=WINDOW,
                bound_mode="static", qk_int8=args.int8, ring=args.ring)

        pairs = sta.sta_pair_count(grid, TILE, WINDOW, lt) + lt * (s + lt)
    flops = 4.0 * d * h * b * pairs
    before = [k.LAUNCHES for k in KERNELS]
    img_out, _ = fn()
    torch.cuda.synchronize()
    ran = [k.__name__ for k, n in zip(KERNELS, before) if k.LAUNCHES > n]
    if not torch.isfinite(img_out.float()).all():
        raise AssertionError(f"{label}: non-finite output")
    ms = min_ms(fn, 5)
    print(f"{label} {args.width}x{args.height}x{args.frames}f S={s} "
          f"grid={grid} pairs={pairs} kernels={','.join(ran)}: {ms:.3f} ms "
          f"{flops / ms / 1e9:.1f} TFLOP/s (x60 layers = {ms * 60 / 1e3:.2f} "
          f"s/step attn)", flush=True)
    return dict(label=label, grid=grid, pairs=pairs, kernels=ran, ms=ms,
                tflops=flops / ms / 1e9)


if __name__ == "__main__":
    main()
