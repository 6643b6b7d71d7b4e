"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):
  1. environment: the card's name and power limit, torch / CUDA / nvcc;
  2. build: the hand-written kernels under hunyuanvideo_efficiency_tpu_torch/
     csrc/, one nvcc per source, all at once;
  3. kernels: each kernel against its plain PyTorch version on the card at
     main-path shapes, with its time, the plain version's time, one PyTorch
     library call's time as a yardstick, and the card's lower bound: K1/K2
     and the int8 flash kernels at the main path's attention, the W8A8
     linear at its qkv, fc1 (fused gelu_tanh) and modulation-matvec shapes,
     K3, and the STA kernels with their int8 arms at 540p (B=2, 24 heads x
     128, a 17x34x60 patch grid, 256 text keys of which 40 are valid, bf16);
  4. main path: HunyuanVideoSampler.from_pretrained at the full width of
     HYVideo-T/2 (bf16), Llama-3-8B + CLIP-L (fp16) and the 884-16c-hy VAE
     (fp16), random weights from fixed seeds, then predict() with CFG at
     256x448, 33 frames, 4 steps, tiled decode; the kernels' launch counts
     are set to 0 just before each path's run and read just after it;
  5. running-max path: the same predict() with the DiT swapped for a
     full-width one without QK-norm (2 double + 2 single blocks) whose
     scores exceed the static kernel's bound, so that flash_attention's
     "auto" dispatch takes K2;
  6. int8 running path: that DiT under attn_mode="flash_int8", 1 step: the
     running-max int8 kernel in every block;
  7. int8 main path: --use-int8 --attn-mode flash_int8 --text-encoder-quant
     int8 at full depth, 2 steps: per step exactly 60 static int8 flash
     launches and one W8A8 launch per block-linear call (400), none of K1;
     the Llama tower's 420 W8A8 launches in the text encoding;
  8. fp8 + int4 path: --use-fp8 --use-int4-modulation at full depth, 1
     step: K1 in all 60 blocks;
  9. STA main path: from_pretrained with --attn-mode sta and one dense
     anchor block per stack, predict() with CFG at 544x960, 65 frames (the
     CLI's 540p), 2 steps: sta_direct in the 58 STA blocks, K1 in the
     anchors and in the text half of every STA block;
 10. STA running-max path: the no-QK-norm 2+2-block DiT of 5 under
     attn_mode="sta" in the same predict() for 1 step: sta_permuted_running
     for the image queries, K2 for the text queries;
 11. STA int8 path: --attn-mode sta_int8 --sta-dense-blocks 1 --use-int8 at
     540p, 1 step: sta_direct_int8 58 times, K1 118 times, W8A8 400 times;
 12. STA permuted path: sta_joint_attention(direct=False) and (fused=False)
     at the shapes of 3, each against the direct arm (B4 vs B6), and the
     int8 permuted arm against its plain version;
 13. reference: the two 2+2-block DiTs, flash kernels vs plain attention,
     then under attn_mode="sta" on a 13x26x28 patch grid (4x4x4 ragged
     tiles) the STA kernels vs the same forward with plain=True; then both
     quantized to int8, the kernels vs plain=True under flash_int8 (and
     sta_int8 for the QK-norm DiT), with the gap to the bf16 DiT reported.
Then the total seconds, one JSON line of per-kernel numbers (launches of
each kernel from the path that runs it: K1 and K3 from 4, K2 from 5, the
running int8 kernel from 6, W8A8 and the static int8 kernel from 7,
sta_direct from 9, sta_permuted_running from 10, sta_direct_int8 from 11,
sta_permuted_static and its int8 arm from 12), the nvidia-smi line, and the
result line. Needs CUDA; there is no CPU fallback.
"""
import dataclasses
import json
import math
import subprocess
import sys
import time
import types

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs
from hunyuanvideo_efficiency_tpu_torch.inference import HunyuanVideoSampler
from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib, quantization
from hunyuanvideo_efficiency_tpu_torch.ops.conv3d import replicate_pad
from hunyuanvideo_efficiency_tpu_torch.ops.conv3d_cuda import (
    conv3d_stride1, conv3d_stride1_plain)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_attention_plain, flash_int8_plain, flash_int8_running,
    flash_int8_static, flash_running, flash_static, int8_bound_inflation,
    int8_key_group, pick_block)
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
    quantize_rows, w8a8_linear, w8a8_linear_plain)
from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
    quantize_dit, quantize_tensor_int8)
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.ops.sta import (
    _unpermute_tokens, permuted_operands, sta_attention_plain, sta_direct,
    sta_direct_int8, sta_joint_attention, sta_pair_count, sta_permuted_plain,
    sta_permuted_running, sta_permuted_static, sta_permuted_static_int8,
    sta_reference_mask)

PEAK_FLOPS = 989e12     # H100 SXM dense bf16/fp16 tensor-core rate
PEAK_INT8 = 1979e12     # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 rate
STEPS = 4
K2_STEPS = 2
HEIGHT, WIDTH, FRAMES = 256, 448, 33
QK_GAIN = 4.0   # scales |q|*|k| by 16: the score bound passes 40
STA_STEPS = 2
STA_RUNNING_STEPS = 1
STA_HEIGHT, STA_WIDTH, STA_FRAMES = 544, 960, 65   # the CLI's 540p
STA_GRID = (17, 34, 60)                            # its patch grid
STA_TILE, STA_WINDOW = (4, 8, 8), (3, 3, 3)
INT8_STEPS = 2
INT8_RUNNING_STEPS = 1
FP8_STEPS = 1
STA_INT8_STEPS = 1
KERNELS = (flash_static, flash_running, conv3d_stride1, sta_direct,
           sta_permuted_static, sta_permuted_running, w8a8_linear,
           flash_int8_static, flash_int8_running, sta_direct_int8,
           sta_permuted_static_int8)
SRC = "hunyuanvideo_efficiency_tpu_torch/csrc/"
JAX = "hunyuanvideo_efficiency_tpu/ops/"


def phase(tag, **fields):
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def cuda_ms(fn, iters):
    """Mean time of fn over `iters` launches, CUDA events, after warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes, int8_ops=0):
    """Least time in ms: bf16 `flops` and `int8_ops` at their peak rates,
    against `nbytes` at the memory rate."""
    t_ops = flops / PEAK_FLOPS + int8_ops / PEAK_INT8
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def errors(out, ref):
    diff = (out.float() - ref.float()).abs().max().item()
    return diff, diff / max(ref.float().abs().max().item(), 1e-30)


def flash_inputs(dev):
    """The main path's attention at 256x448x33: B=2, H=24, D=128, 4032 img
    + 256 txt tokens of which 40 are valid, bf16, RMS-normalized q/k, C from
    the DiT's analytic bound with unit RMSNorm scales."""
    g = torch.Generator(dev).manual_seed(0)
    b, s, h, d, txt_valid = 2, 4032 + 256, 24, 128, 40
    qk = []
    for _ in range(2):
        x = torch.randn(b, s, h, d, generator=g, device=dev)
        qk.append((x * torch.rsqrt(x.square().mean(-1, keepdim=True)))
                  .bfloat16())
    q, k = qk
    v = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    kb = torch.zeros(b, s, device=dev)
    kb[:, 4032 + txt_valid:] = -1e30
    norm = dit_mod.RMSNorm(d, device=dev, dtype=torch.bfloat16)
    c_bound = dit_mod._analytic_score_bound(DiTConfig(), d, [(norm, norm)])
    c = c_bound.expand(b, h).contiguous()
    # the least work: scores and P.V over the unmasked keys only
    flops = 4 * b * h * s * (4032 + txt_valid) * d
    io_bytes = 4 * q.numel() * 2 + kb.numel() * 4
    return q, k, v, kb, c, flops, io_bytes


def check_flash(dev, smi):
    """K1 and K2 at the inputs of flash_inputs."""
    q, k, v, kb, c, flops, io_bytes = flash_inputs(dev)
    b, s, h, d = q.shape
    scale = d ** -0.5
    mask = (kb == 0)[:, None, None, :]
    qt, kt_, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt_, vt, attn_mask=mask), 10)
    rows = []
    for name, running, fn in (
            ("flash_static", False,
             lambda st: flash_static(q, k, v, kb, c, scale, st)),
            ("flash_running", True,
             lambda st: flash_running(q, k, v, kb, scale, st))):
        worst = 0.0
        for state in (False, True):
            out = fn(state)
            ref = flash_attention_plain(q, k, v, kb, c, scale, running, state)
            torch.cuda.synchronize()
            pairs = zip(out, ref) if state else [(out, ref)]
            for o, r in pairs:
                abs_err, rel_err = errors(o, r)
                if rel_err > 2e-2:
                    raise AssertionError(f"{name} state={state}: max rel "
                                         f"error {rel_err} > 2e-2")
                worst = max(worst, abs_err)
            del out, ref
        ms = cuda_ms(lambda: fn(False), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(
            q, k, v, kb, c, scale, running), 3)
        bound_ms, by = bound(flops, io_bytes)
        phase("kernel", name=name, shape=f"[{b},{s},{h},{d}]bf16",
              max_abs_err=worst, tol="rel 2e-2 (bf16)", kernel_ms=ms,
              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
              tflops=flops / ms / 1e9, card=smi)
        rows.append(dict(
            name=name, route="cuda",
            source="hunyuanvideo_efficiency_tpu_torch/csrc/flash_attention.cu",
            replaces=("hunyuanvideo_efficiency_tpu/ops/flash_attention.py:122"
                      if not running else
                      "hunyuanvideo_efficiency_tpu/ops/flash_attention.py:38"),
            max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=by, library_ms=lib_ms))
    return rows


def check_flash_int8(dev, smi, lib_ms):
    """B8a and B8b at the inputs of flash_inputs, k smoothed as
    flash_attention_int8 does, the quantization groups its wrapper picks at
    4,288 tokens (query groups of 1024; key groups of 512 static, 1024
    running), C inflated for int8 rounding; against flash_int8_plain, max
    relative error 2e-2. Yardstick: the bf16 SDPA of check_flash. Bound:
    Q.K^T at the int8 rate plus P.V at the bf16 rate."""
    q, k, v, kb, c, flops, io_bytes = flash_inputs(dev)
    b, s, h, d = q.shape
    scale = d ** -0.5
    k = k - k.float().mean(dim=1, keepdim=True).to(k.dtype)
    c = c * int8_bound_inflation(d)
    qg = pick_block(1024, s)
    bound_ms, by = bound(flops / 2, io_bytes, int8_ops=flops / 2)
    rows = []
    for name, running, line, fn in (
            ("flash_int8_static", False, 657, flash_int8_static),
            ("flash_int8_running", True, 593, flash_int8_running)):
        kg = int8_key_group(pick_block(2048, s), not running)
        args = (q, k, v, kb) + (() if running else (c,)) + (scale, qg, kg)
        out = fn(*args)
        ref = flash_int8_plain(q, k, v, kb, c, scale, running, qg, kg)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(out, ref)
        del out, ref
        if rel_err > 2e-2:
            raise AssertionError(f"{name}: max rel error {rel_err} > 2e-2")
        ms = cuda_ms(lambda: fn(*args), 20)
        plain_ms = cuda_ms(lambda: flash_int8_plain(
            q, k, v, kb, c, scale, running, qg, kg), 2)
        phase("kernel", name=name, shape=f"[{b},{s},{h},{d}]bf16",
              groups=f"q{qg}/k{kg}", max_abs_err=abs_err,
              tol="rel 2e-2 (bf16)", kernel_ms=ms, plain_ms=plain_ms,
              library_ms=lib_ms, bound_ms=bound_ms, card=smi)
        rows.append(dict(
            name=name, route="cuda", source=SRC + "flash_int8.cu",
            replaces=f"{JAX}flash_attention.py:{line}", max_abs_err=abs_err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms))
    return rows


def check_w8a8(dev, smi):
    """B9 at the main path's shapes: the image qkv projection [2*4032,
    3072] -> 9216 (the timed entry), fc1 -> 12288 with the fused gelu_tanh,
    and the double block's modulation matvec [2, 3072] -> 18432; bias on,
    random int8 weights. Against w8a8_linear_plain: equal without an
    activation (the same arithmetic), max relative error 1e-2 with one.
    Yardstick: torch._int_mm on the same s8 operands (rows padded to 32
    for the matvec, which it does not take). Bound: 2*M*N*K at the int8
    rate against x, W, y, scales and bias once each."""
    g = torch.Generator(dev).manual_seed(2)
    row = None
    for m, k, n, act in ((2 * 4032, 3072, 9216, None),
                         (2 * 4032, 3072, 12288, "gelu_tanh"),
                         (2, 3072, 18432, None)):
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w8, so = quantize_tensor_int8(torch.randn(n, k, generator=g,
                                                  device=dev))
        bias = torch.randn(n, generator=g, device=dev).bfloat16()
        out = w8a8_linear(x, w8, so, bias, act)
        ref = w8a8_linear_plain(x, w8, so, bias, act)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(out, ref)
        del out, ref
        if (act is None and abs_err != 0.0) or rel_err > 1e-2:
            raise AssertionError(f"w8a8 [{m},{k}]->{n} act={act}: max abs "
                                 f"error {abs_err}, rel {rel_err}")
        ms = cuda_ms(lambda: w8a8_linear(x, w8, so, bias, act), 20)
        plain_ms = cuda_ms(lambda: w8a8_linear_plain(x, w8, so, bias, act), 3)
        xq = quantize_rows(x)[0]
        if m < 32:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, 32 - m))
        wt = w8.t()
        lib_ms = cuda_ms(lambda: torch._int_mm(xq, wt), 20)
        ops = 2 * m * n * k
        nbytes = m * k * 2 + n * k + m * n * 2 + n * 4 + n * 2
        bound_ms, by = bound(0, nbytes, int8_ops=ops)
        phase("kernel", name="w8a8_linear", shape=f"[{m},{k}]->{n}bf16",
              act=act, max_abs_err=abs_err, tol="exact (no act), rel 1e-2",
              kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
              bound_ms=bound_ms, tops=ops / ms / 1e9, card=smi)
        if row is None:
            row = dict(name="w8a8_linear", route="cuda",
                       source=SRC + "w8a8_linear.cu",
                       replaces=f"{JAX}int8_matmul.py:43", max_abs_err=0.0,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=by, library_ms=lib_ms)
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        del x, w8, xq, wt
    return [row]


def check_conv(dev, smi):
    """K3 (fp16) at the decoder's 128- and 512-channel stages, and at the
    main path's largest stage (the last up block of a 256x256, 33-frame
    decode tile); the last gives the timed entry."""
    g = torch.Generator(dev).manual_seed(1)
    worst = 0.0
    row = None
    for shape in ((1, 9, 64, 64, 128, 128), (1, 9, 32, 32, 512, 512),
                  (1, 33, 256, 256, 128, 128)):
        b, t, hh, ww, cin, cout = shape
        x = torch.randn(b, t, hh, ww, cin, generator=g, device=dev).half()
        xp = replicate_pad(x, (2, 0), (1, 1), (1, 1))
        w = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
             / math.sqrt(27 * cin)).half()
        bias = torch.randn(cout, generator=g, device=dev).half()
        out = conv3d_stride1(xp, w, bias)
        ref = conv3d_stride1_plain(xp, w, bias)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(out, ref)
        if rel_err > 5e-3:
            raise AssertionError(f"conv3d {shape}: max rel error {rel_err} "
                                 f"> 5e-3")
        worst = max(worst, abs_err)
        del out, ref
        flops = 2 * 27 * cin * cout * b * t * hh * ww
        nbytes = (xp.numel() + w.numel() + b * t * hh * ww * cout) * 2 \
            + cout * 2
        ms = cuda_ms(lambda: conv3d_stride1(xp, w, bias), 10)
        plain_ms = cuda_ms(lambda: conv3d_stride1_plain(xp, w, bias), 2)
        x_ncdhw = xp.permute(0, 4, 1, 2, 3)
        w_oi = w.permute(4, 3, 0, 1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv3d(x_ncdhw, w_oi,
                                                            bias), 10)
        bound_ms, by = bound(flops, nbytes)
        phase("kernel", name="conv3d_stride1",
              shape=f"[{b},{t},{hh},{ww},{cin}]->{cout}fp16",
              max_abs_err=abs_err, tol="rel 5e-3 (fp16)", kernel_ms=ms,
              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
              tflops=flops / ms / 1e9, card=smi)
        row = dict(name="conv3d_stride1", route="cuda",
                   source="hunyuanvideo_efficiency_tpu_torch/csrc/conv3d.cu",
                   replaces="hunyuanvideo_efficiency_tpu/ops/"
                            "conv3d_pallas.py:50",
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                   library_ms=lib_ms)
        del xp, x, x_ncdhw
    row["max_abs_err"] = worst
    return [row]


def sta_inputs(dev, seed):
    """The STA phases' inputs at 540p: RMS-normalized q/k (as after the
    DiT's QK-norm with unit scales), random v, 256 text keys of which the
    first 40 are valid, and C from the DiT's analytic bound."""
    g = torch.Generator(dev).manual_seed(seed)
    b, h, d, lt = 2, 24, 128, 256
    s = STA_GRID[0] * STA_GRID[1] * STA_GRID[2]

    def normed(n):
        x = torch.randn(b, n, h, d, generator=g, device=dev)
        return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()

    img = (normed(s), normed(s),
           torch.randn(b, s, h, d, generator=g, device=dev).bfloat16())
    txt = (normed(lt), normed(lt),
           torch.randn(b, lt, h, d, generator=g, device=dev).bfloat16())
    tb = torch.zeros(b, 1, 1, lt, device=dev)
    tb[..., 40:] = -1e30
    norm = dit_mod.RMSNorm(d, device=dev, dtype=torch.bfloat16)
    c = dit_mod._analytic_score_bound(DiTConfig(), d, [(norm, norm)])
    return img, txt, tb, c.expand(b, h).contiguous()


def check_sta(dev, smi):
    """The three STA kernels at 540p against sta_attention_plain (the
    permuted ones through permuted_operands and back), max relative error
    2e-2; bound from the exact count of valid query-key pairs; yardstick:
    SDPA (memory-efficient backend) with the dense STA + text mask."""
    (iq, ik, iv), (_, tk, tv), tb, c = sta_inputs(dev, 11)
    b, s, h, d = iq.shape
    lt, txt_valid = tk.shape[1], 40
    grid, tile, window, scale = STA_GRID, STA_TILE, STA_WINDOW, d ** -0.5
    plan, qp, kcat, vcat, kb = permuted_operands(iq, ik, iv, tk, tv, tb,
                                                 grid, tile, window)
    pairs = sta_pair_count(grid, tile, window, txt_valid)
    flops = 4 * d * h * b * pairs
    io_bytes = 4 * iq.numel() * 2 + 2 * tk.numel() * 2
    bound_ms, by = bound(flops, io_bytes)

    mask = torch.from_numpy(sta_reference_mask(grid, tile, window, s)).to(dev)
    txt_ok = (torch.arange(lt, device=dev) < txt_valid).expand(s, lt)
    mask = torch.cat([mask, txt_ok], dim=1)[None, None]
    qt, kt_, vt = (x.transpose(1, 2) for x in (
        iq, torch.cat([ik, tk], 1), torch.cat([iv, tv], 1)))

    def library():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt_, vt, attn_mask=mask)

    ref = {True: sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile,
                                     window, scale, c),
           False: sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile,
                                      window, scale)}
    lib_out = library().transpose(1, 2).reshape(b, s, h * d)
    lib_err = errors(lib_out, ref[False])[1]
    if lib_err > 2e-2:
        raise AssertionError(f"SDPA yardstick disagrees with the STA plain "
                             f"version: max rel error {lib_err}")
    del lib_out
    lib_ms = cuda_ms(library, 3)
    del mask, qt, kt_, vt
    torch.cuda.empty_cache()

    kernels = (
        ("sta_direct", True, 602,
         lambda: sta_direct(iq, ik, iv, tk, tv, tb, c, grid, tile, window,
                            scale),
         lambda: sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile,
                                     window, scale, c)),
        ("sta_permuted_static", True, 400,
         lambda: sta_permuted_static(qp, kcat, vcat, kb, c, grid, tile,
                                     window, scale),
         lambda: sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                    scale, c)),
        ("sta_permuted_running", False, 267,
         lambda: sta_permuted_running(qp, kcat, vcat, kb, grid, tile, window,
                                      scale),
         lambda: sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                    scale)))
    rows = []
    for name, static, line, fn, plain in kernels:
        out = fn()
        if out.shape[1] != s:
            out = _unpermute_tokens(out, grid, plan)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(out, ref[static])
        del out
        if rel_err > 2e-2:
            raise AssertionError(f"{name}: max rel error {rel_err} > 2e-2")
        ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain, 2)
        phase("kernel", name=name, shape=f"[{b},{s},{h},{d}]bf16",
              grid=json.dumps(grid), tile=json.dumps(tile),
              window=json.dumps(window), text_keys=f"{lt}({txt_valid} valid)",
              pairs_per_head=pairs, max_abs_err=abs_err,
              tol="rel 2e-2 (bf16)", kernel_ms=ms, plain_ms=plain_ms,
              library_ms=lib_ms, library_rel_err=lib_err, bound_ms=bound_ms,
              tflops=flops / ms / 1e9, card=smi)
        rows.append(dict(
            name=name, route="cuda", source=SRC + "sta_attention.cu",
            replaces=f"hunyuanvideo_efficiency_tpu/ops/sta.py:{line}",
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=by, library_ms=lib_ms))
    return rows


def check_sta_int8(dev, smi, lib_ms):
    """The quant arms of B4 and B6 at the 540p inputs of check_sta, C
    inflated for int8 rounding, each against its plain version (the direct
    arm's text keys in bf16, the permuted arm's quantized), max relative
    error 2e-2. Yardstick: the masked SDPA of check_sta. Bound: the image
    (direct) or all (permuted) Q.K^T pairs at the int8 rate, the rest and
    P.V at the bf16 rate."""
    (iq, ik, iv), (_, tk, tv), tb, c = sta_inputs(dev, 13)
    b, s, h, d = iq.shape
    lt, txt_valid = tk.shape[1], 40
    grid, tile, window, scale = STA_GRID, STA_TILE, STA_WINDOW, d ** -0.5
    c = c * int8_bound_inflation(d)
    plan, qp, kcat, vcat, kb = permuted_operands(iq, ik, iv, tk, tv, tb,
                                                 grid, tile, window)
    pairs = sta_pair_count(grid, tile, window, txt_valid)
    img_pairs = sta_pair_count(grid, tile, window, 0)
    per_pair = 2 * d * h * b
    io_bytes = 4 * iq.numel() * 2 + 2 * tk.numel() * 2
    kernels = (
        ("sta_direct_int8", 693, img_pairs,
         lambda: sta_direct_int8(iq, ik, iv, tk, tv, tb, c, grid, tile,
                                 window, scale),
         lambda: sta_attention_plain(iq, ik, iv, tk, tv, tb, grid, tile,
                                     window, scale, c, qk_int8=True)),
        ("sta_permuted_static_int8", 446, pairs,
         lambda: sta_permuted_static_int8(qp, kcat, vcat, kb, c, grid, tile,
                                          window, scale),
         lambda: sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                    scale, c, qk_int8=True)))
    rows = []
    for name, line, int8_pairs, fn, plain in kernels:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        abs_err, rel_err = errors(out, ref)
        del out, ref
        if rel_err > 2e-2:
            raise AssertionError(f"{name}: max rel error {rel_err} > 2e-2")
        ms = cuda_ms(fn, 5)
        plain_ms = cuda_ms(plain, 2)
        bound_ms, by = bound(per_pair * (2 * pairs - int8_pairs), io_bytes,
                             int8_ops=per_pair * int8_pairs)
        phase("kernel", name=name, shape=f"[{b},{s},{h},{d}]bf16",
              grid=json.dumps(grid), tile=json.dumps(tile),
              text_keys=f"{lt}({txt_valid} valid)", max_abs_err=abs_err,
              tol="rel 2e-2 (bf16)", kernel_ms=ms, plain_ms=plain_ms,
              library_ms=lib_ms, bound_ms=bound_ms, card=smi)
        rows.append(dict(
            name=name, route="cuda", source=SRC + "sta_attention.cu",
            replaces=f"{JAX}sta.py:{line}", max_abs_err=abs_err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms))
    return rows


def randomize_modulation(model, seed):
    """init_weights zero-inits the adaLN and final layers (every block is
    then the identity): give them random values, re-quantized in the tier
    a layer holds."""
    g = torch.Generator(model.img_in.proj.weight.device).manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if hasattr(mod, "in_features") and (
                    name.endswith("mod.linear")
                    or name.endswith("modulation.linear")
                    or "adaLN_modulation" in name
                    or name.startswith("final_layer")):
                w = torch.empty(mod.out_features, mod.in_features,
                                device=g.device).normal_(
                    0.0, 0.5 / math.sqrt(mod.in_features), generator=g)
                if isinstance(mod, torch.nn.Linear):
                    mod.weight.copy_(w)
                else:   # a weight tier: its own converter, same buffers
                    tier = quantization.TIER_OF[type(mod)]
                    mod.load_state_dict(tier(types.SimpleNamespace(
                        weight=w, bias=mod.bias)).state_dict())


def build_sampler(**flags):
    """from_pretrained at the full width of HYVideo-T/2 with random weights
    (the adaLN layers randomized) and the given CLI flags; also returns the
    build seconds."""
    args = InferenceArgs(model="HYVideo-T/2", vae_tiling=True,
                         model_base="ckpts-not-present", **flags)
    t0 = time.time()
    sampler = HunyuanVideoSampler.from_pretrained(args=args,
                                                  allow_random_init=True)
    randomize_modulation(sampler.transformer, 3)
    torch.cuda.synchronize()
    return sampler, time.time() - t0


def weight_bytes(model):
    """Bytes of every parameter and buffer of `model` (codes and scales of
    the quantized tiers included)."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict(keep_vars=True).values())


def main_path(smi):
    sampler, build_s = build_sampler()
    n_params = sum(p.numel() for p in sampler.transformer.parameters())
    prompt = "A cat walks on the grass, realistic style."

    t0 = time.time()
    sampler.pipeline.encode_prompt(prompt, sampler.default_negative_prompt,
                                   True)
    torch.cuda.synchronize()
    text_s = time.time() - t0

    reset_counts()
    r = timed_predict(sampler, prompt, (FRAMES, HEIGHT, WIDTH), STEPS, 42)
    launches = r["launches"]
    phase("main_path", dit_params=n_params, build_s=build_s,
          text_encode_s=text_s, s_per_step=r["s_per_step"],
          first_step_s=r["first_step_s"], decode_s=r["decode_s"],
          gen_s=r["gen_s"],
          max_memory_allocated_gb=r["max_memory_allocated_gb"],
          dit_gb=weight_bytes(sampler.transformer) / 2**30,
          launches=json.dumps(launches), card=smi)
    if launches["flash_static"] != 60 * STEPS \
            or launches["flash_running"] != 0:
        raise AssertionError(f"attention launches {launches}, expected "
                             f"{60 * STEPS} of K1 and none of K2")
    if launches["conv3d_stride1"] == 0:
        raise AssertionError("K3 was not launched during decode")
    return sampler, launches


def build_unnormed_dit(dev, seed):
    """HYVideo-T/2 width without QK-norm, 2 double + 2 single blocks, the
    q and k columns of the joint-attention qkv projections scaled by
    QK_GAIN: the Cauchy-Schwarz bound of the scores then exceeds 40, and
    flash_attention's "auto" dispatch takes the running-max kernel (K2),
    as it does for any such model with large scores."""
    cfg = dataclasses.replace(DiTConfig(), qk_norm=False,
                              mm_double_blocks_depth=2,
                              mm_single_blocks_depth=2)
    model = dit_mod.build_dit(cfg, dev, torch.bfloat16,
                              torch.Generator(dev).manual_seed(seed))
    randomize_modulation(model, seed + 1)
    h = cfg.hidden_size
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.endswith(("img_attn_qkv", "txt_attn_qkv", "linear1")):
                mod.weight[:2 * h] *= QK_GAIN
    return model


def running_max_path(sampler, smi):
    """predict() through a DiT whose attention takes K2 in every block."""
    model = build_unnormed_dit(sampler.device, 8)
    sampler.transformer = sampler.pipeline.transformer = model
    torch.cuda.empty_cache()
    prompt = "A dog runs along the beach at sunset."
    reset_counts()
    out = sampler.predict(prompt, height=HEIGHT, width=WIDTH,
                          video_length=FRAMES, seed=43, infer_steps=K2_STEPS,
                          guidance_scale=6.0, flow_shift=7.0,
                          output_dtype="uint8")
    launches = read_counts()
    phase("running_max_path", blocks="2+2", qk_norm=False, steps=K2_STEPS,
          gen_s=out["gen_time"], launches=json.dumps(launches), card=smi)
    check_video(out["samples"])
    if launches["flash_running"] != 4 * K2_STEPS \
            or launches["flash_static"] != 0:
        raise AssertionError(f"attention launches {launches}, expected "
                             f"{4 * K2_STEPS} of K2 and none of K1")
    return model, launches


def sta_main_path(smi):
    """predict() under --attn-mode sta at 540p through the CLI's own
    arguments: one dense anchor block per stack, the rest sta_direct."""
    sampler, build_s = build_sampler(attn_mode="sta", sta_dense_blocks=1)
    reset_counts()
    r = timed_predict(sampler, "A cat walks on the grass, realistic style.",
                      (STA_FRAMES, STA_HEIGHT, STA_WIDTH), STA_STEPS, 42)
    launches = r["launches"]
    phase("sta_main_path", size=f"{STA_HEIGHT}x{STA_WIDTH}x{STA_FRAMES}",
          tokens=STA_GRID[0] * STA_GRID[1] * STA_GRID[2], steps=STA_STEPS,
          dense_blocks="1+1", build_s=build_s, s_per_step=r["s_per_step"],
          first_step_s=r["first_step_s"], decode_s=r["decode_s"],
          gen_s=r["gen_s"],
          max_memory_allocated_gb=r["max_memory_allocated_gb"],
          launches=json.dumps(launches), card=smi)
    want = dict(sta_direct=58 * STA_STEPS,
                flash_static=(2 + 2 * 58) * STA_STEPS, flash_running=0,
                sta_permuted_static=0, sta_permuted_running=0)
    if any(launches[k] != n for k, n in want.items()) \
            or launches["conv3d_stride1"] == 0:
        raise AssertionError(f"STA main path launches {launches}, expected "
                             f"{want} and K3 in the decode")
    return sampler, launches


def sta_running_path(sampler, model, smi):
    """predict() at 540p through the no-QK-norm 2+2-block DiT under
    attn_mode="sta": its image queries take sta_permuted_running, its text
    queries (score bound above 40) K2."""
    set_attn_mode(model, "sta")
    sampler.transformer = sampler.pipeline.transformer = model
    torch.cuda.empty_cache()
    reset_counts()
    out = sampler.predict("A dog runs along the beach at sunset.",
                          height=STA_HEIGHT, width=STA_WIDTH,
                          video_length=STA_FRAMES, seed=43,
                          infer_steps=STA_RUNNING_STEPS, guidance_scale=6.0,
                          flow_shift=7.0, output_dtype="uint8")
    launches = read_counts()
    phase("sta_running_path", blocks="2+2", qk_norm=False,
          steps=STA_RUNNING_STEPS, gen_s=out["gen_time"],
          launches=json.dumps(launches), card=smi)
    check_video(out["samples"], (STA_FRAMES, STA_HEIGHT, STA_WIDTH))
    n = 4 * STA_RUNNING_STEPS
    if launches["sta_permuted_running"] != n \
            or launches["flash_running"] != n or launches["sta_direct"] != 0:
        raise AssertionError(f"STA running path launches {launches}, "
                             f"expected {n} of sta_permuted_running and of "
                             f"K2, none of sta_direct")
    return launches


def block_linear_calls(model):
    """W8A8 calls of one DiT forward, from the module structure: each of a
    double block's 10 linears runs once; a single block's 3 run 5 times
    (modulation once, linear1 for the qkv and the MLP columns, linear2 for
    the attention and the MLP rows)."""
    per_double = sum(isinstance(m, quantization.Int8Linear)
                     for m in model.double_blocks[0].modules())
    per_single = sum(isinstance(m, quantization.Int8Linear)
                     for m in model.single_blocks[0].modules())
    if (per_double, per_single) != (10, 3):
        raise AssertionError(f"int8 linears per block {per_double}, "
                             f"{per_single}; expected 10 and 3")
    return 10 * len(model.double_blocks) + 5 * len(model.single_blocks)


def timed_predict(sampler, prompt, size, steps, seed):
    """predict() with CFG, the launch counts of each denoise step (read at
    the step callback), step marks and the peak memory of the call."""
    frames, height, width = size
    marks, at_step = [], []

    def on_step(i, latents):
        torch.cuda.synchronize()
        marks.append(time.time())
        at_step.append(read_counts())

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    out = sampler.predict(prompt, height=height, width=width,
                          video_length=frames, seed=seed, infer_steps=steps,
                          guidance_scale=6.0, flow_shift=7.0,
                          output_dtype="uint8", progress_callback=on_step)
    t_end = time.time()
    check_video(out["samples"], size)
    steps_s = [b - a for a, b in zip(marks, marks[1:])]
    per_step = [{k: b[k] - a[k] for k in b} for a, b in zip(at_step,
                                                          at_step[1:])]
    return dict(out=out, launches=read_counts(), per_step=per_step,
                s_per_step=sum(steps_s) / len(steps_s) if steps_s else None,
                first_step_s=marks[0] - t0, decode_s=t_end - marks[-1],
                gen_s=out["gen_time"],
                max_memory_allocated_gb=(torch.cuda.max_memory_allocated()
                                         / 2**30))


def expect(label, got, want):
    bad = {k: (got[k], n) for k, n in want.items() if got[k] != n}
    if bad:
        raise AssertionError(f"{label}: launches (got, expected) {bad}")


def int8_running_path(sampler, model, smi):
    """predict() through the no-QK-norm 2+2-block DiT under
    attn_mode="flash_int8": without a score bound every block takes the
    running-max int8 kernel (B8b)."""
    set_attn_mode(model, "flash_int8")
    sampler.transformer = sampler.pipeline.transformer = model
    reset_counts()
    r = timed_predict(sampler, "A dog runs along the beach at sunset.",
                      (FRAMES, HEIGHT, WIDTH), INT8_RUNNING_STEPS, 44)
    phase("int8_running_path", blocks="2+2", qk_norm=False,
          steps=INT8_RUNNING_STEPS, gen_s=r["gen_s"],
          launches=json.dumps(r["launches"]), card=smi)
    n = 4 * INT8_RUNNING_STEPS
    expect("int8 running path", r["launches"], dict(
        flash_int8_running=n, flash_int8_static=0, flash_running=0,
        flash_static=0, w8a8_linear=0))
    return r["launches"]


def int8_main_path(smi):
    """predict() with --use-int8 --attn-mode flash_int8 --text-encoder-quant
    int8 at full depth and width: W8A8 in every block linear and in the
    Llama tower, B8a in all 60 blocks; exact launch counts per step."""
    sampler, build_s = build_sampler(use_int8=True, attn_mode="flash_int8",
                                     text_encoder_quant="int8")
    prompt = "A cat walks on the grass, realistic style."
    llm = sampler.text_encoder.model
    text_calls = 2 * 7 * (len(llm.layers)
                          - sampler.args.hidden_state_skip_layer)
    reset_counts()
    sampler.pipeline.encode_prompt(prompt, sampler.default_negative_prompt,
                                   True)
    expect("int8 text encode", read_counts(), dict(w8a8_linear=text_calls))
    calls = block_linear_calls(sampler.transformer)
    reset_counts()
    r = timed_predict(sampler, prompt, (FRAMES, HEIGHT, WIDTH), INT8_STEPS,
                      42)
    phase("int8_main_path", flags="--use-int8 --attn-mode flash_int8 "
          "--text-encoder-quant int8", steps=INT8_STEPS, build_s=build_s,
          s_per_step=r["s_per_step"], first_step_s=r["first_step_s"],
          decode_s=r["decode_s"], gen_s=r["gen_s"],
          max_memory_allocated_gb=r["max_memory_allocated_gb"],
          dit_gb=weight_bytes(sampler.transformer) / 2**30,
          llm_gb=weight_bytes(llm) / 2**30,
          launches=json.dumps(r["launches"]),
          per_step=json.dumps(r["per_step"]), card=smi)
    for step in r["per_step"]:
        expect("int8 main path step", step, dict(
            w8a8_linear=calls, flash_int8_static=60, flash_int8_running=0,
            flash_static=0, flash_running=0))
    expect("int8 main path", r["launches"], dict(
        w8a8_linear=text_calls + calls * INT8_STEPS,
        flash_int8_static=60 * INT8_STEPS, flash_static=0))
    return r["launches"]


def fp8_int4_path(smi):
    """predict() with --use-fp8 --use-int4-modulation at full depth: the
    block linears dequantized to bf16 (no Pallas kernel in JAX either),
    K1 in all 60 blocks."""
    sampler, build_s = build_sampler(use_fp8=True, use_int4_modulation=True)
    reset_counts()
    r = timed_predict(sampler, "A cat walks on the grass, realistic style.",
                      (FRAMES, HEIGHT, WIDTH), FP8_STEPS, 42)
    phase("fp8_int4_path", flags="--use-fp8 --use-int4-modulation",
          steps=FP8_STEPS, build_s=build_s, first_step_s=r["first_step_s"],
          decode_s=r["decode_s"], gen_s=r["gen_s"],
          max_memory_allocated_gb=r["max_memory_allocated_gb"],
          dit_gb=weight_bytes(sampler.transformer) / 2**30,
          launches=json.dumps(r["launches"]), card=smi)
    expect("fp8 + int4 path", r["launches"], dict(
        flash_static=60 * FP8_STEPS, w8a8_linear=0, flash_int8_static=0))


def sta_int8_path(smi):
    """predict() with --attn-mode sta_int8 --sta-dense-blocks 1 --use-int8
    at 540p: sta_direct_int8 in the 58 STA blocks, K1 in the two dense
    anchors and the text half of every STA block, W8A8 in every block."""
    sampler, build_s = build_sampler(attn_mode="sta_int8",
                                     sta_dense_blocks=1, use_int8=True)
    calls = block_linear_calls(sampler.transformer)
    reset_counts()
    r = timed_predict(sampler, "A cat walks on the grass, realistic style.",
                      (STA_FRAMES, STA_HEIGHT, STA_WIDTH), STA_INT8_STEPS, 42)
    phase("sta_int8_path", size=f"{STA_HEIGHT}x{STA_WIDTH}x{STA_FRAMES}",
          flags="--attn-mode sta_int8 --sta-dense-blocks 1 --use-int8",
          steps=STA_INT8_STEPS, build_s=build_s,
          first_step_s=r["first_step_s"], decode_s=r["decode_s"],
          gen_s=r["gen_s"],
          max_memory_allocated_gb=r["max_memory_allocated_gb"],
          launches=json.dumps(r["launches"]), card=smi)
    n = STA_INT8_STEPS
    expect("STA int8 path", r["launches"], dict(
        sta_direct_int8=58 * n, flash_static=(2 + 2 * 58) * n,
        w8a8_linear=calls * n, sta_direct=0, flash_running=0,
        sta_permuted_static_int8=0))
    return r["launches"]


def sta_permuted_path(dev, smi):
    """sta_joint_attention's permuted static arm (direct=False, and
    fused=False), the entry point of B6, each against the direct arm on
    the same 540p inputs (image and text outputs)."""
    img, txt, tb, c = sta_inputs(dev, 12)
    kw = dict(grid=STA_GRID, tile=STA_TILE, window=STA_WINDOW,
              bound_mode="static", score_bound=c)
    direct = sta_joint_attention(*img, *txt, tb, **kw)
    reset_counts()
    worst = 0.0
    for arm in (dict(direct=False), dict(fused=False)):
        outs = sta_joint_attention(*img, *txt, tb, **kw, **arm)
        torch.cuda.synchronize()
        for o, r in zip(outs, direct):
            rel_err = errors(o, r)[1]
            if rel_err > 2e-2:
                raise AssertionError(f"sta_joint_attention({arm}) vs "
                                     f"direct: max rel error {rel_err}")
            worst = max(worst, rel_err)
    # the int8 arm: text blocks quantized like key tiles, so its reference
    # is the same call on the plain version
    kw8 = dict(kw, qk_int8=True, direct=False)
    outs = sta_joint_attention(*img, *txt, tb, **kw8)
    ref = sta_joint_attention(*img, *txt, tb, **kw8, plain=True)
    torch.cuda.synchronize()
    worst8 = max(errors(o, r)[1] for o, r in zip(outs, ref))
    launches = read_counts()
    phase("sta_permuted_path", check="direct=False and fused=False vs "
          "direct; qk_int8 direct=False vs its plain version",
          max_rel_err=worst, int8_max_rel_err=worst8, tol=2e-2,
          launches=json.dumps(launches), card=smi)
    if worst8 > 2e-2:
        raise AssertionError(f"int8 permuted arm vs plain: max rel error "
                             f"{worst8}")
    expect("permuted path", launches, dict(sta_permuted_static=2,
                                           sta_permuted_static_int8=1))
    return launches


def set_attn_mode(model, mode):
    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), DiTConfig):
            m.cfg = dataclasses.replace(m.cfg, attn_mode=mode)


def reset_counts():
    for fn in KERNELS:
        fn.LAUNCHES = 0


def read_counts():
    return {fn.__name__: fn.LAUNCHES for fn in KERNELS}


def check_video(video, size=(FRAMES, HEIGHT, WIDTH)):
    if tuple(video.shape) != (1, 3, *size) or video.dtype != torch.uint8:
        raise AssertionError(f"video {tuple(video.shape)} {video.dtype}")
    vf = video.float()
    if not torch.isfinite(vf).all() or vf.std().item() == 0.0:
        raise AssertionError("video is not finite or is constant")


def reference_check(dev, models):
    """Each full-width 2+2-block DiT: the forward with the flash kernels
    against the same weights with plain attention, on one small input."""
    g = torch.Generator(dev).manual_seed(7)
    x = torch.randn(2, 16, 3, 16, 16, generator=g, device=dev)
    t = torch.tensor([900.0, 900.0], device=dev)
    txt = torch.randn(2, 64, 4096, generator=g, device=dev)
    mask = torch.ones(2, 64, dtype=torch.long, device=dev)
    mask[:, 20:] = 0
    txt2 = torch.randn(2, 768, generator=g, device=dev)
    for label, model in models.items():
        cfg = model.cfg
        cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, (3, 8, 8),
                                           theta=cfg.rope_theta, device=dev)
        outs = {}
        for mode in ("flash", "sdpa"):
            set_attn_mode(model, mode)
            reset_counts()
            with torch.no_grad():
                outs[mode] = model(x, t, txt, mask, txt2, cos, sin).float()
            if mode == "flash":
                launches = read_counts()
        diff = ((outs["flash"] - outs["sdpa"]).norm()
                / outs["sdpa"].norm()).item()
        finite = bool(torch.isfinite(outs["flash"]).all())
        phase("reference", model=label, check="flash vs plain attention",
              rel_l2=diff, tol=5e-2, finite=finite,
              launches=json.dumps(launches))
        if not finite or diff > 5e-2:
            raise AssertionError(f"{label}: flash forward disagrees with "
                                 f"plain attention: rel L2 {diff}")


def sta_reference_check(dev, models):
    """Each full-width 2+2-block DiT under attn_mode="sta" on a 13x26x28
    patch grid (4x4x4 tiles of 4x8x8, ragged on every axis, so the 3x3x3
    window leaves tiles out): the STA kernels against the same forward with
    the STA image queries on sta_attention_plain (plain=True)."""
    g = torch.Generator(dev).manual_seed(9)
    grid = (13, 26, 28)
    x = torch.randn(2, 16, grid[0], 2 * grid[1], 2 * grid[2], generator=g,
                    device=dev)
    t = torch.tensor([900.0, 900.0], device=dev)
    txt = torch.randn(2, 64, 4096, generator=g, device=dev)
    mask = torch.ones(2, 64, dtype=torch.long, device=dev)
    mask[:, 20:] = 0
    txt2 = torch.randn(2, 768, generator=g, device=dev)
    for label, model in models.items():
        set_attn_mode(model, "sta")
        cfg = model.cfg
        cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, grid,
                                           theta=cfg.rope_theta, device=dev)
        reset_counts()
        with torch.no_grad():
            out = model(x, t, txt, mask, txt2, cos, sin).float()
            launches = read_counts()
            ref = model(x, t, txt, mask, txt2, cos, sin,
                        plain=True).float()
        diff = ((out - ref).norm() / ref.norm()).item()
        finite = bool(torch.isfinite(out).all())
        phase("sta_reference", model=label, grid=json.dumps(grid),
              check="STA kernels vs sta_attention_plain", rel_l2=diff,
              tol=5e-2, finite=finite, launches=json.dumps(launches))
        sta_launches = (launches["sta_direct"]
                        + launches["sta_permuted_running"])
        if not finite or diff > 5e-2 or sta_launches != 4:
            raise AssertionError(f"{label}: STA forward disagrees with the "
                                 f"plain version: rel L2 {diff}, launches "
                                 f"{launches}")


def int8_reference_check(dev, models):
    """Each 2+2-block DiT with int8 weights (quantized in place here, after
    the bf16 checks): the forward with the kernels against the same
    quantized model through the plain versions (plain=True: W8A8, int8
    attention, STA image queries), relative L2 5e-2 under flash_int8, and
    for the QK-norm DiT under sta_int8 on the ragged 13x26x28 grid. The gap
    of the int8 DiT to the bf16 one (flash) is reported, not gated."""
    g = torch.Generator(dev).manual_seed(10)
    t = torch.tensor([900.0, 900.0], device=dev)
    txt = torch.randn(2, 64, 4096, generator=g, device=dev)
    mask = torch.ones(2, 64, dtype=torch.long, device=dev)
    mask[:, 20:] = 0
    txt2 = torch.randn(2, 768, generator=g, device=dev)
    for label, model in models.items():
        cfg = model.cfg
        cases = [("flash_int8", (3, 8, 8))]
        if cfg.qk_norm:
            cases.append(("sta_int8", (13, 26, 28)))
        for mode, grid in cases:
            x = torch.randn(2, 16, grid[0], 2 * grid[1], 2 * grid[2],
                            generator=g, device=dev)
            cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, grid,
                                               theta=cfg.rope_theta,
                                               device=dev)
            gap = None
            if mode == "flash_int8":
                set_attn_mode(model, "flash")
                bf16 = model(x, t, txt, mask, txt2, cos, sin).float()
                quantize_dit(model, int8=True)
            set_attn_mode(model, mode)
            reset_counts()
            out = model(x, t, txt, mask, txt2, cos, sin).float()
            launches = read_counts()
            ref = model(x, t, txt, mask, txt2, cos, sin, plain=True).float()
            diff = ((out - ref).norm() / ref.norm()).item()
            if mode == "flash_int8":
                gap = ((out - bf16).norm() / bf16.norm()).item()
            finite = bool(torch.isfinite(out).all())
            phase("int8_reference", model=label, mode=mode,
                  grid=json.dumps(grid), check="kernels vs plain versions, "
                  "int8 weights", rel_l2=diff, tol=5e-2, finite=finite,
                  rel_l2_to_bf16_not_gated=gap,
                  launches=json.dumps(launches))
            attn = {"flash_int8": ("flash_int8_static" if cfg.qk_norm
                                   else "flash_int8_running"),
                    "sta_int8": "sta_direct_int8"}[mode]
            if not finite or diff > 5e-2:
                raise AssertionError(f"{label} {mode}: kernels disagree with "
                                     f"the plain versions: rel L2 {diff}")
            expect(f"{label} {mode}", launches, {
                attn: 4, "w8a8_linear": block_linear_calls(model)})


@torch.no_grad()
def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True
                          ).stdout.strip().splitlines()[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("env", card=smi, torch=torch.__version__, cuda=torch.version.cuda,
          nvcc=json.dumps(nvcc), python=sys.version.split()[0])

    t0 = time.time()
    cuda_lib.build()
    phase("build", seconds=time.time() - t0,
          libraries=len(cuda_lib.SIGNATURES))

    rows = check_flash(dev, smi)
    rows += check_flash_int8(dev, smi, rows[0]["library_ms"])
    rows += check_w8a8(dev, smi) + check_conv(dev, smi)
    sta_rows = check_sta(dev, smi)
    rows += sta_rows + check_sta_int8(dev, smi, sta_rows[0]["library_ms"])
    torch.cuda.empty_cache()
    sampler, launches = main_path(smi)
    k2_model, k2_launches = running_max_path(sampler, smi)
    launches["flash_running"] = k2_launches["flash_running"]
    launches["flash_int8_running"] = int8_running_path(
        sampler, k2_model, smi)["flash_int8_running"]
    del sampler
    torch.cuda.empty_cache()
    int8_launches = int8_main_path(smi)
    for name in ("w8a8_linear", "flash_int8_static"):
        launches[name] = int8_launches[name]
    torch.cuda.empty_cache()
    fp8_int4_path(smi)
    torch.cuda.empty_cache()
    sampler, sta_launches = sta_main_path(smi)
    launches["sta_direct"] = sta_launches["sta_direct"]
    launches["sta_permuted_running"] = sta_running_path(
        sampler, k2_model, smi)["sta_permuted_running"]
    del sampler
    torch.cuda.empty_cache()
    launches["sta_direct_int8"] = sta_int8_path(smi)["sta_direct_int8"]
    torch.cuda.empty_cache()
    perm_launches = sta_permuted_path(dev, smi)
    for name in ("sta_permuted_static", "sta_permuted_static_int8"):
        launches[name] = perm_launches[name]
    torch.cuda.empty_cache()
    k1_model = dit_mod.build_dit(
        dataclasses.replace(DiTConfig(), mm_double_blocks_depth=2,
                            mm_single_blocks_depth=2),
        dev, torch.bfloat16, torch.Generator(dev).manual_seed(5))
    randomize_modulation(k1_model, 6)
    models = {"HYVideo-T/2 2+2 blocks": k1_model,
              "no QK-norm 2+2 blocks": k2_model}
    reference_check(dev, models)
    sta_reference_check(dev, models)
    int8_reference_check(dev, models)
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    phase("total", seconds=time.time() - t_start)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
