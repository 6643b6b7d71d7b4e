"""Check and time the wgmma STA kernels: B4 and B4q (csrc/sta_direct.cu),
the ring kernel B10 (its RING arm), the running-max permuted kernel B7 and
the static permuted kernels B6a/B6b and B6q (csrc/sta_permuted.cu).

    python -m hunyuanvideo_efficiency_tpu_torch.probes.sta_direct_bench \\
        [--reps N] [--ptxas] [--no-check] [--against DIR]

At the STA main path's attention at 540p, [2, 34680, 24, 128] bf16 on the
17x34x60 patch grid, tile (4, 8, 8), window (3, 3, 3), 256 text keys of
which 40 are valid, q and k of unit RMS and v a column view of a fused
[2, S, 3*H*D] projection, C the Cauchy-Schwarz bound sqrt(D) (B4q:
inflated for the int8 rounding; B6q likewise): each kernel against its
plain version (max error relative to the output's scale 2e-2, two runs
equal bit for bit; skipped with --no-check), its time (CUDA events over
--reps launches) and its bound (4*D operations per valid query-key pair,
sta_pair_count; the Q.K^T half of B4q's image pairs and of all B6q's pairs
at the int8 rate), and for B4q and B6q their pre-pass alone. B10 runs on
its own operands (q as a 5-D view, K/V copied to w-major order), B7, B6a
and B6q on permuted_operands' (tile-major q, [img | text] keys and their
bias, compared in tile-major order, padding rows zero). --against
DIR runs the wrappers of the same names from the package copy under DIR
(another checkout, such as a parent commit unpacked with `git archive`;
its kernels build into its own build directory) on the same inputs:
checked against this copy's plain version, and timed in turns with this
copy's (this, other, other, this). One JSON line a kernel, with the card's
name and power limit. With --ptxas it first compiles csrc/sta_direct.cu and
csrc/sta_permuted.cu with `-Xptxas -v,-warn-spills` and prints ptxas's
lines and the SASS's counts (flash_bwd_bench.ptxas_report). Exits non-zero on a mismatch or without a
CUDA device.
"""
import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import sta
from ..ops.flash_attention import int8_bound_inflation
from .flash_bwd_bench import cuda_ms, ptxas_report

PEAK_FLOPS, PEAK_INT8 = 989e12, 1979e12
GRID, TILE, WINDOW = (17, 34, 60), (4, 8, 8), (3, 3, 3)
B, H, D, LT, LT_VALID = 2, 24, 128, 256, 40
KERNELS = ("sta_direct", "sta_direct_int8", "sta_ring",
           "sta_permuted_running", "sta_permuted_static",
           "sta_permuted_static_int8")


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


def package_sta(root):
    """ops/sta.py of the package copy under the checkout `root`, imported
    under another name beside this one."""
    pkg = Path(root).resolve() / "hunyuanvideo_efficiency_tpu_torch"
    name = "hvtorch_against"
    spec = importlib.util.spec_from_file_location(
        name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.sta")


def calls(mod, name, q, k, v, tk, tv, tb, scale):
    """(the kernel's call with `mod`'s wrapper, its plain version from this
    copy) on the shared inputs."""
    c = torch.full((B, H), D ** 0.5, device=q.device)
    if name in ("sta_direct", "sta_direct_int8"):
        if name == "sta_direct_int8":
            c = c * int8_bound_inflation(D)
        fn = getattr(mod, name)
        return (lambda: fn(q, k, v, tk, tv, tb, c, GRID, TILE, WINDOW,
                           scale),
                lambda: sta.sta_attention_plain(
                    q, k, v, tk, tv, tb, GRID, TILE, WINDOW, scale, c,
                    qk_int8=name == "sta_direct_int8"))
    if name == "sta_ring":
        pg = sta._padded_grid(GRID, TILE)
        args = (q.reshape(B, *GRID, H * D),
                sta._permute_tokens_cols(k, GRID, TILE, pg),
                sta._permute_tokens_cols(v, GRID, TILE, pg),
                tk.reshape(B, LT, H * D), tv.reshape(B, LT, H * D),
                tb.reshape(B, LT), c, GRID, TILE, WINDOW, scale)
        return (lambda: mod.sta_ring(*args),
                lambda: sta.sta_ring_plain(*args))
    _, qp, kcat, vcat, kb = sta.permuted_operands(q, k, v, tk, tv, tb, GRID,
                                                  TILE, WINDOW)
    if name == "sta_permuted_running":
        args = (qp, kcat, vcat, kb, GRID, TILE, WINDOW, scale)
        return (lambda: mod.sta_permuted_running(*args),
                lambda: sta.sta_permuted_plain(*args))
    quant = name == "sta_permuted_static_int8"
    if quant:
        c = c * int8_bound_inflation(D)
    fn = getattr(mod, name)
    return (lambda: fn(qp, kcat, vcat, kb, c, GRID, TILE, WINDOW, scale),
            lambda: sta.sta_permuted_plain(qp, kcat, vcat, kb, GRID, TILE,
                                           WINDOW, scale, c, qk_int8=quant))


def prepass(name, q, k, v, tk, tv, tb):
    """The int8 arms' quantizing pre-pass alone on the operands its kernel
    reads, or None."""
    if name == "sta_direct_int8":
        return lambda: sta.sta_tile_codes(q, k, GRID, TILE)
    if name == "sta_permuted_static_int8":
        _, qp, kcat, _, _ = sta.permuted_operands(q, k, v, tk, tv, tb, GRID,
                                                  TILE, WINDOW)
        return lambda: sta.sta_permuted_codes(qp, kcat, TILE)
    return None


def check(name, run, plain):
    """Max abs and relative error of run() against plain(), two runs equal
    bit for bit; exits on a mismatch."""
    got, again = run(), run()
    want = plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    rel = err / want.float().abs().max().item()
    if rel > 2e-2 or not torch.isfinite(got.float()).all():
        sys.exit(f"{name}: max rel error {rel}")
    if not torch.equal(got, again):
        sys.exit(f"{name}: two runs differ")
    return err, rel


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-check", dest="check", action="store_false")
    ap.add_argument("--against", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("sta_direct_bench needs a CUDA device")
    if args.ptxas:
        for src in ("sta_direct", "sta_permuted"):
            ptxas_report(src)
    other = package_sta(args.against) if args.against else None
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
    for name in KERNELS:
        run, plain = calls(sta, name, q, k, v, tk, tv, tb, scale)
        row = dict(name=name, shape=f"[{B},{q.shape[1]},{H},{D}]bf16")
        run_other = (calls(other, name, q, k, v, tk, tv, tb, scale)[0]
                     if other else None)
        if args.check:
            row["max_abs_err"], row["max_rel_err"] = check(name, run, plain)
            if run_other:
                row["against_max_abs_err"], row["against_max_rel_err"] = \
                    check(f"{name} ({args.against})", run_other, plain)
        if run_other:
            turns = [cuda_ms(run, args.reps), cuda_ms(run_other, args.reps),
                     cuda_ms(run_other, args.reps), cuda_ms(run, args.reps)]
            ms = (turns[0] + turns[3]) / 2
            row.update(against=args.against, turns_ms=turns,
                       against_ms=(turns[1] + turns[2]) / 2)
        else:
            ms = cuda_ms(run, args.reps)
        per_pair = 4 * D * H * B
        int8_pairs = {"sta_direct_int8": img_pairs,
                      "sta_permuted_static_int8": pairs}.get(name, 0)
        codes = prepass(name, q, k, v, tk, tv, tb)
        if codes:
            row["prepass_ms"] = cuda_ms(codes, args.reps)
        bound = (per_pair * (pairs - int8_pairs / 2) / PEAK_FLOPS
                 + per_pair * int8_pairs / 2 / PEAK_INT8) * 1e3
        row.update(ms=ms, bound_ms=bound, share=bound / ms,
                   tflops=per_pair * pairs / ms / 1e9, card=card)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
