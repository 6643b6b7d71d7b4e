"""Check and time the direct STA kernels B4 and B4q (csrc/sta_direct.cu).

    python -m hunyuanvideo_efficiency_tpu_torch.probes.sta_direct_bench \\
        [--reps N] [--ptxas] [--no-check]

At the STA main path's attention at 540p, [2, 34680, 24, 128] bf16 on the
17x34x60 patch grid, tile (4, 8, 8), window (3, 3, 3), 256 text keys of
which 40 are valid, q and k of unit RMS and v a column view of a fused
[2, S, 3*H*D] projection, C the Cauchy-Schwarz bound sqrt(D) (B4q: inflated
for the int8 rounding): each kernel against its plain version (max error
relative to the output's scale 2e-2, two runs equal bit for bit; skipped
with --no-check), its time (CUDA events over --reps launches) and its bound
(4*D operations per valid query-key pair, sta_pair_count; B4q's image
Q.K^T half at the int8 rate), and for B4q its pre-pass alone. One JSON line
a kernel, with the card's name and power limit. With --ptxas it first
compiles csrc/sta_direct.cu with `-Xptxas -v,-warn-spills` and prints
ptxas's lines and the SASS's counts (flash_bwd_bench.ptxas_report). Exits
non-zero on a mismatch or without a CUDA device.
"""
import argparse
import json
import subprocess
import sys

import torch

from ..ops import sta
from ..ops.flash_attention import int8_bound_inflation
from .flash_bwd_bench import cuda_ms, ptxas_report

PEAK_FLOPS, PEAK_INT8 = 989e12, 1979e12
GRID, TILE, WINDOW = (17, 34, 60), (4, 8, 8), (3, 3, 3)
B, H, D, LT, LT_VALID = 2, 24, 128, 256, 40


def inputs(dev):
    g = torch.Generator(dev).manual_seed(6)
    s = GRID[0] * GRID[1] * GRID[2]

    def rms(x):
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True))

    fused = torch.randn(B, s, 3, H, D, generator=g, device=dev)
    fused[:, :, :2] = rms(fused[:, :, :2])
    fused = fused.bfloat16()
    tk = rms(torch.randn(B, LT, H, D, generator=g, device=dev)).bfloat16()
    tv = torch.randn(B, LT, H, D, generator=g, device=dev).bfloat16()
    tb = torch.zeros(B, 1, 1, LT, device=dev)
    tb[..., LT_VALID:] = -1e30
    return (fused[:, :, 0].contiguous(), fused[:, :, 1].contiguous(),
            fused[:, :, 2], tk, tv, tb)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-check", dest="check", action="store_false")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("sta_direct_bench needs a CUDA device")
    if args.ptxas:
        ptxas_report("sta_direct")
    dev = torch.device("cuda")
    q, k, v, tk, tv, tb = inputs(dev)
    scale = D ** -0.5
    pairs = sta.sta_pair_count(GRID, TILE, WINDOW, LT_VALID)
    img_pairs = sta.sta_pair_count(GRID, TILE, WINDOW, 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = []
    for name, quant in (("sta_direct", False), ("sta_direct_int8", True)):
        c = torch.full((B, H), D ** 0.5, device=dev)
        if quant:
            c = c * int8_bound_inflation(D)
        fn = sta.sta_direct_int8 if quant else sta.sta_direct

        def run():
            return fn(q, k, v, tk, tv, tb, c, GRID, TILE, WINDOW, scale)

        row = dict(name=name, shape=f"[{B},{q.shape[1]},{H},{D}]bf16")
        if args.check:
            got, again = run(), run()
            want = sta.sta_attention_plain(q, k, v, tk, tv, tb, GRID, TILE,
                                           WINDOW, scale, c, qk_int8=quant)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            rel = err / want.float().abs().max().item()
            if rel > 2e-2 or not torch.isfinite(got.float()).all():
                sys.exit(f"{name}: max rel error {rel}")
            if not torch.equal(got, again):
                sys.exit(f"{name}: two runs differ")
            row.update(max_abs_err=err, max_rel_err=rel)
            del got, again, want
        ms = cuda_ms(run, args.reps)
        per_pair = 4 * D * H * B
        if quant:
            bound = (per_pair * (pairs - img_pairs / 2) / PEAK_FLOPS
                     + per_pair * img_pairs / 2 / PEAK_INT8) * 1e3
            row["prepass_ms"] = cuda_ms(
                lambda: sta.sta_tile_codes(q, k, GRID, TILE), args.reps)
        else:
            bound = per_pair * pairs / PEAK_FLOPS * 1e3
        row.update(ms=ms, bound_ms=bound, share=bound / ms,
                   tflops=per_pair * pairs / ms / 1e9, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
