"""Check and time the training backward kernels B5q and B5kv.

    python -m hunyuanvideo_efficiency_tpu_torch.probes.flash_bwd_bench \\
        [--reps N] [--ptxas]

At the train step's attention, [1, 4288, 24, 128] bf16 (4,032 image and
256 text tokens, 216 text keys masked), q and k contiguous and v a column
view of a fused [1, S, 3*H*D] projection, with a random dO and the plain
forward's lse and delta: each kernel against its plain version (max
relative error 2e-2, two runs equal bit for bit, masked keys' dK and dV
exactly zero), its time (CUDA events over --reps launches), its bound (3
and 4 products of 2*B*H*Sq*Sk_valid*D operations at 989 TFLOP/s) and
SDPA's whole backward through autograd on the same inputs, which computes
dQ, dK and dV in one pass. One JSON line a kernel, then one for the pair.
With --ptxas it first compiles csrc/flash_backward.cu with `-Xptxas
-v,-warn-spills` and prints ptxas's lines (registers, spills, the C7514 /
C7515 warnings of serialized wgmma) and the count of local stores (`STL`)
in the SASS. Exits non-zero on a mismatch or without a CUDA device.
"""
import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_lib
from ..ops.flash_backward import (flash_bwd_dkv, flash_bwd_dkv_plain,
                                  flash_bwd_dq, flash_bwd_dq_plain,
                                  flash_fwd_lse_plain, plan_flash_bwd,
                                  row_delta)

PEAK_FLOPS = 989e12
B, IMG, TXT, TXT_VALID, H, D = 1, 4032, 256, 40, 24, 128


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


def ptxas_report(name="flash_backward"):
    """ptxas's lines for csrc/<name>.cu, and in its SASS the count of local
    stores and of warpgroup (HGMMA, IGMMA) and warp (HMMA, IMMA) products;
    exits if nvcc fails."""
    nvcc = cuda_lib.nvcc_path()
    src = cuda_lib.CSRC / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / f"{name}.cubin"
        flags = [f for f in cuda_lib.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        out = subprocess.run(
            [nvcc, *flags, "-cubin", "-Xptxas", "-v,-warn-spills", "-I",
             str(cuda_lib.CSRC), "-o", str(cubin), str(src)],
            capture_output=True, text=True)
        print(out.stdout + out.stderr, flush=True)
        if out.returncode:
            sys.exit("nvcc failed")
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", str(cubin)],
            capture_output=True, text=True).stdout
    print(json.dumps({f"sass_{op}": sass.count(op) for op in (
        "STL", "HGMMA", "IGMMA", "HMMA", "IMMA")}), flush=True)


def inputs(dev):
    g = torch.Generator(dev).manual_seed(4)
    s = IMG + TXT
    fused = torch.randn(B, s, 3, H, D, generator=g, device=dev)
    fused[:, :, :2] = fused[:, :, :2] * torch.rsqrt(
        fused[:, :, :2].square().mean(-1, keepdim=True))
    fused = fused.bfloat16()
    q, k = fused[:, :, 0].contiguous(), fused[:, :, 1].contiguous()
    v = fused[:, :, 2]
    do = torch.randn(B, s, H * D, generator=g, device=dev).bfloat16()
    kb = torch.zeros(B, s, device=dev)
    kb[:, IMG + TXT_VALID:] = -1e30
    return q, k, v, kb, do


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("flash_bwd_bench needs a CUDA device")
    if args.ptxas:
        ptxas_report()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    q, k, v, kb, do = inputs(dev)
    s, scale = q.shape[1], D ** -0.5
    out, lse = flash_fwd_lse_plain(q, k, v, kb, scale)
    delta = row_delta(do, out, H)
    call = (q, k, v, kb, do, lse, delta, scale)
    masked = kb[0] < 0
    product = 2 * B * H * s * (IMG + TXT_VALID) * D

    mask = (kb == 0)[:, None, None, :]
    with torch.enable_grad():
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask)
    dot = do.reshape(B, s, H, D).transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, leaves, dot, retain_graph=True), args.reps)
    del lib_out, leaves

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    total = 0.0
    for name, kernel, fn, plain, products in (
            ("flash_bwd_dq", "dq", lambda: (flash_bwd_dq(*call),),
             lambda: (flash_bwd_dq_plain(*call),), 3),
            ("flash_bwd_dkv", "dkv", lambda: flash_bwd_dkv(*call),
             lambda: flash_bwd_dkv_plain(*call), 4)):
        got, again, want = fn(), fn(), plain()
        torch.cuda.synchronize()
        worst = 0.0
        for i, (x, x2, ref) in enumerate(zip(got, again, want)):
            err = (x.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            if rel > 2e-2 or not torch.isfinite(x.float()).all():
                sys.exit(f"{name} output {i}: max rel error {rel}")
            if not torch.equal(x, x2):
                sys.exit(f"{name} output {i}: two runs differ")
            if kernel == "dkv" and torch.count_nonzero(x[:, masked]).item():
                sys.exit(f"{name} output {i}: masked keys are not zero")
            worst = max(worst, err)
        del got, again, want
        ms = cuda_ms(fn, args.reps)
        total += ms
        bound_ms = products * product / PEAK_FLOPS * 1e3
        plan = plan_flash_bwd(kernel, B, H, s, s, D)
        print(json.dumps({
            "kernel": name, "shape": f"[{B},{s},{H},{D}]bf16",
            "max_abs_err": worst, "ms": ms, "bound_ms": bound_ms,
            "bound_share": bound_ms / ms, "tflops": products * product / ms
            / 1e9, "sdpa_backward_ms": lib_ms, "grid": plan.grid,
            "turns": plan.turns, "smem": plan.smem, "card": card}),
            flush=True)
    print(json.dumps({"pair_ms": total, "sdpa_backward_ms": lib_ms,
                      "pair_over_sdpa": total / lib_ms, "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
