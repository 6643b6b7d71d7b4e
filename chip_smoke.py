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
     linear at its qkv, fc1 (fused gelu_tanh), modulation-matvec, text-qkv
     and linear2-MLP-rows (a K slice) shapes, each with its pre-pass alone,
     K3 and the temporal-reuse conv B11 on the same inputs, K3 and
     F.conv3d timed once at each distinct K3 shape of the main path's
     decode with its launch count (`[conv_decode]`), B11 again at
     the conv probe's three bf16 decoder stages (its timed entry from the
     first, the probe being the path that runs it), and the STA
     kernels with their int8 arms and the ring kernel B10 at 540p (B=2, 24
     heads x 128, a 17x34x60 patch grid, 256 text keys of which 40 are
     valid, bf16; B4, its int8 arm and the ring kernel B10 are
     csrc/sta_direct.cu, the running kernel B7, the static permuted ones
     B6a/B6b and their int8 arm B6q csrc/sta_permuted.cu; B10 also against
     B4 on the same inputs); K1/K2 again on their key-range split path at
     the STA text merge's shape (256 text queries over the 34,680 image
     keys), and one timed launch each of K1, the static int8 kernel B8a and
     SDPA at the headline 720x1280x129f shape (119,056 tokens) and of B4 at
     its image queries (118,800 on the 33x45x80 grid; timings, not
     checks); B8a/B8b also show their quantization pre-pass alone and K1 on
     the same inputs;
  4. main path: HunyuanVideoSampler.from_pretrained at the full width of
     HYVideo-T/2 (bf16), Llama-3-8B + CLIP-L (fp16) and the 884-16c-hy VAE
     (fp16), random weights from fixed seeds, then predict() with CFG at
     256x448, 33 frames, 4 steps, tiled decode; the kernels' launch counts
     are set to 0 just before each path's run and read just after it, and
     every predict() launches K3 exactly as often as its decode's shapes
     need (conv_probe.decode_k3_shapes: 186 at 256x448x33, 930 at 540p);
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
     anchors and in the text half of every STA block; then the same
     predict() under sta.set_sta_ring(True): sta_ring 58 times a step and
     none of sta_direct, the switch reset afterwards;
 10. STA running-max path: the no-QK-norm 2+2-block DiT of 5 under
     attn_mode="sta" in the same predict() for 1 step: sta_permuted_running
     for the image queries, K2 for the text queries;
 11. STA int8 path: --attn-mode sta_int8 --sta-dense-blocks 1 --use-int8 at
     540p, 1 step: sta_direct_int8 58 times, K1 118 times, W8A8 400 times;
 12. STA permuted path: sta_joint_attention(direct=False) and (fused=False)
     at the shapes of 3, each against the direct arm (B4 vs B6), and the
     int8 permuted arm against its plain version; then the conv probe
     (probes/conv_probe.py, one timed call a form): F.conv3d, K3 and B11 at
     the decoder's three heavy stages after a numerics check;
 12b. harness path (`[harness_path]`): the t-ops experiment harness as a
     user runs it, on two seeded smooth 240x432x33 `.pt` videos and four
     t-ops configs (all off, the first `pool` and the first `stride` config
     of the enumeration, one decoder interpolation), each through the
     sweep's steps, run_experiment (the full-width 884-16c-hy VAE in fp16,
     random weights) and compute_metrics_dir (PSNR, SSIM and random-weight
     LPIPS on the card), the ranking by PSNR, then the base config through
     the `infer` entry with --enable-tiling; K3 launches exactly 20 times in
     every Encoder call (an encode tile) and 31 times in every Decoder call
     (a decode tile) under every config and the tiled run, timed by CUDA
     events around those calls; each config's saved reconstruction of one
     video against the same weights in fp32 (F.conv3d; relative L2 within
     2e-2), every distinct K3 shape of those encodes and decodes against
     F.conv3d (5e-3), and the metrics of two configs recomputed on the CPU
     (PSNR and SSIM within 1e-9, LPIPS within 1e-4 relative);
 13. reference: the two 2+2-block DiTs, flash kernels vs plain attention,
     then under attn_mode="sta" on a 13x26x28 patch grid (4x4x4 ragged
     tiles) the STA kernels vs the same forward with plain=True, and for
     the QK-norm DiT again under set_sta_ring(True) (sta_ring); then both
     quantized to int8, the kernels vs plain=True under flash_int8 (and
     sta_int8 for the QK-norm DiT), with the gap to the bf16 DiT reported.
 14. train path: a trainable bf16 DiT at the full width and depth of
     HYVideo-T/2 (20 + 40 blocks, every block checkpointed), batch 1,
     256x448x33f latents (4,032 + 256 tokens), 4 SGD steps of
     training.make_train_step on a fixed batch: per step exactly 60 launches
     each of K1 (a block's first forward, without grad), the forward with
     LSE (its recomputation) and the dQ and dK/dV backward kernels; the
     loss is finite and lower at the last step, the first block's qkv
     gradient is non-zero; seconds per step is the median after the first;
 15. AdamW train path: make_train_step_adamw (fp32 master, Adam moments,
     EMA, global-norm clip) at full width and reduced depth (4 + 8 blocks),
     3 steps: the loss falls, the parameters are the bf16 rounding of the
     master bit for bit, the EMA is finite and differs from the master;
 16. STA train path: a 2+2-block full-width DiT under attn_mode="sta" on a
     5x16x24 patch grid, one SGD step: sta_direct in both forwards of each
     block, gradients (autograd through sta_gathered_attention) finite and
     non-zero;
 17. gradient reference: the QK-norm 2+2-block DiT's flow-match loss
     gradients with the flash kernels (checkpointed) against the same model
     under plain attention (attn_mode="sdpa"), relative L2 per parameter;
 18. train entry path: the command a user runs, `python -m
     hunyuanvideo_efficiency_tpu_torch.train` (train.main), on a directory
     of 256x448x33f `.pt` latents written here under the temporary
     directory: `--optimizer sgd` at the full depth, 2 steps and a 24 GiB
     checkpoint (60 launches of each kernel a step); then the default
     AdamW + master + EMA loop at full width and a depth of 1 + 1 blocks
     (`--blocks 1 1`: a checkpoint is 18 bytes a parameter), 2 steps and a
     checkpoint, then `--resume` to step 4: per step exactly 2 launches
     each of K1 and the three training kernels, finite losses, the
     checkpoint's files, `module` through the sampler's loader equal to
     the rounded `master` bit for bit, the resumed optimizer count.
The three training kernels are checked in 3 at the shape the train path
gives them (batch 1, 4,288 tokens, q and k contiguous, v a column view of
the fused projection as in a single block: out and lse; dQ; dK and dV) with
SDPA's forward and backward as their yardsticks.
Then the total seconds, one JSON line of per-kernel numbers (launches of
each kernel from the path that runs it: K1 and K3 from 4, K2 from 5, the
running int8 kernel from 6, W8A8 and the static int8 kernel from 7,
sta_direct and sta_ring from 9, sta_permuted_running from 10,
sta_direct_int8 from 11, sta_permuted_static and its int8 arm and B11 from
12, the three training kernels from 14), the nvidia-smi line, and the
result line. Needs CUDA; there is no
CPU fallback.
"""
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import types

import torch
from torch.nn.attention import SDPBackend, sdpa_kernel

from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs
from hunyuanvideo_efficiency_tpu_torch.experiments import (
    ExperimentResult, base_config, rank_results, run_experiment,
    write_configs)
from hunyuanvideo_efficiency_tpu_torch.inference import HunyuanVideoSampler
from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib, quantization
from hunyuanvideo_efficiency_tpu_torch.ops.conv3d import replicate_pad
from hunyuanvideo_efficiency_tpu_torch.ops.conv3d_cuda import (
    conv3d_stride1, conv3d_stride1_plain, conv3d_stride1_v2)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_backward import (
    flash_bwd_dkv, flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain,
    flash_fwd_lse, flash_fwd_lse_plain, row_delta)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_attention_plain, flash_int8_plain, flash_int8_running,
    flash_int8_static, flash_running, flash_splits, flash_static,
    int8_bound_inflation, int8_key_group, pick_block, quantize_groups)
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import (
    plan_w8a8, quantize_rows, w8a8_linear, w8a8_linear_plain, w8a8_prepass)
from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
    quantize_dit, quantize_tensor_int8)
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.ops.sta import (
    _padded_grid, _permute_tokens_cols, _unpermute_tokens, permuted_operands,
    set_sta_ring, sta_attention_plain, sta_direct, sta_direct_int8,
    sta_joint_attention, sta_pair_count, sta_permuted_codes,
    sta_permuted_plain, sta_permuted_running, sta_permuted_static,
    sta_permuted_static_int8, sta_reference_mask, sta_ring, sta_ring_plain,
    sta_tile_codes)
from hunyuanvideo_efficiency_tpu_torch.probes import conv_probe
from hunyuanvideo_efficiency_tpu_torch.probes.w8a8_bench import graph_ms
from hunyuanvideo_efficiency_tpu_torch.training import (
    flow_match_loss, make_train_step, make_train_step_adamw)

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
TRAIN_STEPS, TRAIN_LR = 4, 0.1
TRAIN_LATENT = (16, 9, 32, 56)       # 256x448x33f: a 9x16x28 patch grid
ADAMW_STEPS, ADAMW_LR, ADAMW_BLOCKS = 3, 1e-4, (4, 8)
ENTRY_STEPS, ENTRY_BLOCKS = 2, (1, 1)
STA_TRAIN_LATENT = (16, 5, 32, 48)   # a 5x16x24 patch grid, 2x2x3 tiles
# the t-ops harness: 240p short side as the reference's mp42tensor writes
# it, 432 the multiple of 16 nearest 16:9
HARNESS_HEIGHT, HARNESS_WIDTH, HARNESS_FRAMES = 240, 432, 33
HARNESS_VIDEOS = 2
KERNELS = (flash_static, flash_running, conv3d_stride1, sta_direct,
           sta_permuted_static, sta_permuted_running, w8a8_linear,
           flash_int8_static, flash_int8_running, sta_direct_int8,
           sta_permuted_static_int8, flash_fwd_lse, flash_bwd_dq,
           flash_bwd_dkv, sta_ring, conv3d_stride1_v2)
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


def rms_normed(g, dev, *shape):
    """bf16 rows of unit RMS, as after the DiT's QK-norm with unit scales."""
    x = torch.randn(*shape, generator=g, device=dev)
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()


def analytic_bound(dev, b, h, d=128):
    norm = dit_mod.RMSNorm(d, device=dev, dtype=torch.bfloat16)
    c = dit_mod._analytic_score_bound(DiTConfig(), d, [(norm, norm)])
    return c.expand(b, h).contiguous()


def flash_inputs(dev, b=2):
    """The main path's attention at 256x448x33: B=2 (CFG; a train step has
    b=1), H=24, D=128, 4032 img + 256 txt tokens of which 40 are valid,
    bf16, RMS-normalized q/k, C from the DiT's analytic bound with unit
    RMSNorm scales."""
    g = torch.Generator(dev).manual_seed(0)
    s, h, d, txt_valid = 4032 + 256, 24, 128, 40
    q, k = rms_normed(g, dev, b, s, h, d), rms_normed(g, dev, b, s, h, d)
    v = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    kb = torch.zeros(b, s, device=dev)
    kb[:, 4032 + txt_valid:] = -1e30
    c = analytic_bound(dev, b, h, d)
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
    check_flash_split(dev, smi)
    time_flash_headline(dev, smi)
    return rows


def check_flash_split(dev, smi):
    """K1 and K2 on their key-range split path at the 540p STA text merge's
    first call (ops/sta.py:txt_merge_attention): 256 text queries over the
    34,680 image keys of the 17x34x60 grid, B=2, 24 heads x 128, bf16,
    with the (m, l) state; the wrapper splits each query tile's keys over
    several blocks and merges them in a second kernel (one launch counted).
    Against the plain version, max relative error 2e-2 on out, m and l;
    timed beside SDPA over the same keys. Bound: the larger of 4*B*H*Sq*Sk*D
    operations and the bytes of q, k, v, out and the state."""
    g = torch.Generator(dev).manual_seed(4)
    b, h, d, lt = 2, 24, 128, 256
    s = STA_GRID[0] * STA_GRID[1] * STA_GRID[2]
    q, k = rms_normed(g, dev, b, lt, h, d), rms_normed(g, dev, b, s, h, d)
    v = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    c = analytic_bound(dev, b, h, d)
    scale = d ** -0.5
    splits = flash_splits(
        b, h, lt, s, torch.cuda.get_device_properties(dev).multi_processor_count)
    if splits < 2:
        raise AssertionError(f"the text merge's shape should split, got "
                             f"{splits}")
    qt, kt_, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt_, vt), 10)
    flops = 4 * b * h * lt * s * d
    io_bytes = (2 * q.numel() + 2 * k.numel()) * 2 + 2 * b * lt * h * 4
    bound_ms, by = bound(flops, io_bytes)
    for name, running, fn in (
            ("flash_static", False,
             lambda st: flash_static(q, k, v, None, c, scale, st)),
            ("flash_running", True,
             lambda st: flash_running(q, k, v, None, scale, st))):
        out = fn(True)
        ref = flash_attention_plain(q, k, v, None, c, scale, running, True)
        torch.cuda.synchronize()
        worst = 0.0
        for o, r in zip(out, ref):
            abs_err, rel_err = errors(o, r)
            if rel_err > 2e-2:
                raise AssertionError(f"{name} split path: max rel error "
                                     f"{rel_err} > 2e-2")
            worst = max(worst, abs_err)
        del out, ref
        ms = cuda_ms(lambda: fn(False), 20)
        plain_ms = cuda_ms(lambda: flash_attention_plain(
            q, k, v, None, c, scale, running), 2)
        phase("kernel", name=name, path="key-range split", splits=splits,
              shape=f"q[{b},{lt},{h},{d}]k[{b},{s},{h},{d}]bf16",
              max_abs_err=worst, tol="rel 2e-2 (bf16)", kernel_ms=ms,
              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
              bound_by=by, tflops=flops / ms / 1e9, card=smi)


def time_flash_headline(dev, smi):
    """One timed launch each of K1 and SDPA at the reference's headline
    shape, 720x1280x129f: B=2 (CFG), 118,800 image + 256 text tokens of
    which 40 are valid, 24 heads x 128, bf16, RMS-normalized q/k, C from
    the analytic bound. A timing, not a check: the plain version's scores
    would not fit, so K1's correctness is the 4,288-token check (here the
    output is only checked finite). SDPA runs over the 118,840 unmasked
    keys alone (the masked keys add nothing to the softmax), which lets it
    take its flash backend. Bound: 4*B*H*Sq*Sk_valid*D operations."""
    g = torch.Generator(dev).manual_seed(5)
    b, h, d, n_img, lt, valid = 2, 24, 128, 118800, 256, 40
    s, keys = n_img + lt, n_img + valid
    q, k = rms_normed(g, dev, b, s, h, d), rms_normed(g, dev, b, s, h, d)
    v = torch.randn(b, s, h, d, generator=g, device=dev).bfloat16()
    kb = torch.zeros(b, s, device=dev)
    kb[:, keys:] = -1e30
    c = analytic_bound(dev, b, h, d)

    def once(fn):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    out, ms = once(lambda: flash_static(q, k, v, kb, c, d ** -0.5))
    if out.shape != (b, s, h * d) or not torch.isfinite(out).all():
        raise AssertionError("flash_static at the headline shape: output "
                             "not finite or of the wrong shape")
    del out
    time_int8_headline(q, k, v, kb, c, keys, smi, once)
    qt = q.transpose(1, 2)
    kt_, vt = (x[:, :keys].transpose(1, 2).contiguous() for x in (k, v))
    del k, v
    _, lib_ms = once(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt_, vt))
    flops = 4 * b * h * s * keys * d
    bound_ms, by = bound(flops, 4 * q.numel() * 2)
    phase("headline", name="flash_static", shape=f"[{b},{s},{h},{d}]bf16",
          valid_keys=keys, kernel_ms=ms, library_ms=lib_ms,
          bound_ms=bound_ms, bound_by=by, tflops=flops / ms / 1e9,
          library_tflops=flops / lib_ms / 1e9,
          check="timing only (finite output)", card=smi)
    del q, qt, kt_, vt
    torch.cuda.empty_cache()


def time_int8_headline(q, k, v, kb, c, keys, smi, once):
    """One timed B8a launch at the headline shape, on time_flash_headline's
    inputs (k as the caller gives it; C inflated for int8 rounding) with
    the groups the wrapper picks at that length: a timing, the output only
    checked finite. Bound: Q.K^T at the int8 rate plus P.V at the bf16
    rate over the valid keys, against the bytes of q, k, v and out."""
    b, s, h, d = q.shape
    qg = pick_block(1024, s)
    kg = int8_key_group(pick_block(2048, s), True)
    c8 = c * int8_bound_inflation(d)
    out, ms = once(lambda: flash_int8_static(q, k, v, kb, c8, d ** -0.5, qg,
                                             kg))
    if out.shape != (b, s, h * d) or not torch.isfinite(out).all():
        raise AssertionError("flash_int8_static at the headline shape: "
                             "output not finite or of the wrong shape")
    del out
    flops = 4 * b * h * s * keys * d
    bound_ms, by = bound(flops / 2, 4 * q.numel() * 2, int8_ops=flops / 2)
    phase("headline", name="flash_int8_static", shape=f"[{b},{s},{h},{d}]"
          "bf16", groups=f"q{qg}/k{kg}", valid_keys=keys, kernel_ms=ms,
          bound_ms=bound_ms, bound_by=by, tops=flops / ms / 1e9,
          check="timing only (finite output)", card=smi)


def check_flash_int8(dev, smi, lib_ms):
    """B8a and B8b at the inputs of flash_inputs, k smoothed as
    flash_attention_int8 does, the quantization groups its wrapper picks at
    4,288 tokens (query groups of 1024; key groups of 512 static, 1024
    running), C inflated for int8 rounding; against flash_int8_plain, max
    relative error 2e-2. Yardstick: the bf16 SDPA of check_flash. Bound:
    Q.K^T at the int8 rate plus P.V at the bf16 rate. Beside each: the
    quantization pre-pass alone (quant_ms, part of the kernel's time) and
    K1 on the same inputs (k1_ms; K2 for the running kernel, k2_ms)."""
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
        quant_ms = cuda_ms(lambda: quantize_groups(q, k, qg, kg), 20)
        k1_ms = cuda_ms(lambda: flash_static(q, k, v, kb, c, scale), 20)
        bf16 = ({"k2_ms": cuda_ms(lambda: flash_running(q, k, v, kb, scale),
                                  20)} if running else {})
        plain_ms = cuda_ms(lambda: flash_int8_plain(
            q, k, v, kb, c, scale, running, qg, kg), 2)
        phase("kernel", name=name, shape=f"[{b},{s},{h},{d}]bf16",
              groups=f"q{qg}/k{kg}", max_abs_err=abs_err,
              tol="rel 2e-2 (bf16)", kernel_ms=ms, quant_ms=quant_ms,
              k1_ms=k1_ms, **bf16, plain_ms=plain_ms, library_ms=lib_ms,
              bound_ms=bound_ms, bound_share=bound_ms / ms, card=smi)
        rows.append(dict(
            name=name, route="cuda", source=SRC + "flash_int8.cu",
            replaces=f"{JAX}flash_attention.py:{line}", max_abs_err=abs_err,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms))
    return rows


def check_flash_backward(dev, smi):
    """B5f, B5q and B5kv at the shape the train path gives them: batch 1,
    the tokens of flash_inputs, q and k contiguous (the outputs of QK-norm
    and RoPE), v a column view of a fused [1, S, 3*H*D] projection (what a
    single block passes; 40 of the 60 blocks), a random dO. Each against its
    plain version: out and dQ/dK/dV max relative error 2e-2 (bf16 outputs),
    lse max abs error 2e-3 (fp32, sums in another order); dK and dV of the
    masked text keys exactly zero; two runs equal bit for bit. The backward
    kernels and their plain versions read the same lse and delta (the plain
    forward's). Yardsticks: SDPA's forward for B5f and SDPA's backward
    through autograd, which computes dQ, dK and dV in one pass, for B5q and
    B5kv alike. Bounds: 2, 3 and 4 products of 2*B*H*Sq*Sk_valid*D
    operations against each tensor once. Each kernel's line gives its share
    of the bound, and a `[kernel_pair]` line B5q + B5kv against SDPA's
    backward."""
    q, k, v, kb, _, flops, _ = flash_inputs(dev, b=1)
    b, s, h, d = q.shape
    fused = torch.zeros(b, s, 3, h, d, dtype=v.dtype, device=dev)
    fused[:, :, 2] = v
    v = fused[:, :, 2]
    assert q.is_contiguous() and not v.is_contiguous()
    scale = d ** -0.5
    g = torch.Generator(dev).manual_seed(3)
    do = torch.randn(b, s, h * d, generator=g, device=dev).bfloat16()
    ref_out, ref_lse = flash_fwd_lse_plain(q, k, v, kb, scale)
    delta = row_delta(do, ref_out, h)
    args = (q, k, v, kb, do, ref_lse, delta, scale)
    masked = kb[0] < 0
    tensor = q.numel() * 2
    stats = (ref_lse.numel() + kb.numel()) * 4

    mask = (kb == 0)[:, None, None, :]
    with torch.enable_grad():
        leaves = [x.transpose(1, 2).detach().requires_grad_(True)
                  for x in (q, k, v)]
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            *leaves, attn_mask=mask)
    fwd_lib_ms = cuda_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            *(x.detach() for x in leaves), attn_mask=mask), 10)
    dot = do.reshape(b, s, h, d).transpose(1, 2)
    bwd_lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, leaves, dot, retain_graph=True), 10)
    del lib_out, leaves

    def run_fwd():
        return flash_fwd_lse(q, k, v, kb, scale)

    def run_dkv():
        return flash_bwd_dkv(*args)

    cases = (
        ("flash_fwd_lse", "flash_attention.cu", 40, run_fwd,
         lambda: flash_fwd_lse_plain(q, k, v, kb, scale), flops,
         4 * tensor + stats, fwd_lib_ms),
        ("flash_bwd_dq", "flash_backward.cu", 138,
         lambda: (flash_bwd_dq(*args),),
         lambda: (flash_bwd_dq_plain(*args),), 1.5 * flops,
         5 * tensor + 2 * stats, bwd_lib_ms),
        ("flash_bwd_dkv", "flash_backward.cu", 165, run_dkv,
         lambda: flash_bwd_dkv_plain(*args), 2 * flops,
         6 * tensor + 2 * stats, bwd_lib_ms))
    rows = []
    for name, source, line, fn, plain, ops, nbytes, lib_ms in cases:
        out, again, ref = fn(), fn(), plain()
        torch.cuda.synchronize()
        worst = 0.0
        for i, (o, o2, r) in enumerate(zip(out, again, ref)):
            abs_err, rel_err = errors(o, r)
            is_lse = name == "flash_fwd_lse" and i == 1
            if (abs_err > 2e-3) if is_lse else (rel_err > 2e-2):
                raise AssertionError(f"{name} output {i}: max abs error "
                                     f"{abs_err}, rel {rel_err}")
            if not torch.equal(o, o2):
                raise AssertionError(f"{name} output {i}: two runs differ")
            if name == "flash_bwd_dkv" and (
                    torch.count_nonzero(o[:, masked]).item()
                    or not torch.count_nonzero(o[:, ~masked]).item()):
                raise AssertionError(f"{name} output {i}: masked keys must "
                                     f"get exactly zero, the others not")
            worst = max(worst, abs_err)
        del out, again, ref
        ms = cuda_ms(fn, 10)
        plain_ms = cuda_ms(plain, 2)
        bound_ms, by = bound(ops, nbytes)
        phase("kernel", name=name, shape=f"[{b},{s},{h},{d}]bf16",
              v="column view of fused qkv", max_abs_err=worst,
              tol="rel 2e-2 (bf16), lse abs 2e-3", kernel_ms=ms,
              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
              bound_share=bound_ms / ms, tflops=ops / ms / 1e9, card=smi)
        rows.append(dict(
            name=name, route="cuda", source=SRC + source,
            replaces=f"{JAX}flash_backward.py:{line}", max_abs_err=worst,
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms))
    pair_ms = rows[1]["ms"] + rows[2]["ms"]
    phase("kernel_pair", names="flash_bwd_dq+flash_bwd_dkv", ms=pair_ms,
          bound_ms=rows[1]["bound_ms"] + rows[2]["bound_ms"],
          sdpa_backward_ms=bwd_lib_ms, over_sdpa=pair_ms / bwd_lib_ms,
          card=smi)
    return rows


def check_w8a8(dev, smi):
    """B9 at the main path's shapes: the image qkv projection [2*4032,
    3072] -> 9216 (the timed entry), fc1 -> 12288 with the fused gelu_tanh,
    the double block's modulation matvec [2, 3072] -> 18432 (the split-K
    schedule), the text stream's qkv [512, 3072] -> 9216 (middle M) and the
    single block's linear2 MLP rows [8576, 12288] -> 3072, a K slice of a
    [3072, 15360] weight; bias on, random int8 weights. Against
    w8a8_linear_plain: equal without an activation (the same arithmetic),
    max relative error 1e-2 with one. Times: the device time of a call
    (w8a8_bench.graph_ms: 20 calls in one CUDA graph, replayed; the host's
    launch cost of a call exceeds a matvec's device time) and, as
    eager_ms, back-to-back calls with the host's cost. Each shape also
    shows its pre-pass alone (quant_ms, part of kernel_ms) and the
    schedule plan_w8a8 took.
    Yardstick: torch._int_mm on the same s8 operands (rows padded to 32
    for the matvec, which it does not take; codes only, no quantization or
    epilogue), timed the same way. Bound: 2*M*N*K at the int8 rate against
    x, W, y, scales and bias once each."""
    g = torch.Generator(dev).manual_seed(2)
    row = None
    for m, k, n, act, k_slice in ((2 * 4032, 3072, 9216, None, None),
                                  (2 * 4032, 3072, 12288, "gelu_tanh", None),
                                  (2, 3072, 18432, None, None),
                                  (512, 3072, 9216, None, None),
                                  (2 * 4288, 12288, 3072, None, 3072)):
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w8, so = quantize_tensor_int8(torch.randn(
            n, k + (k_slice or 0), generator=g, device=dev))
        if k_slice:
            w8 = w8[:, k_slice:]     # linear2's MLP rows: stride 15360
        bias = torch.randn(n, generator=g, device=dev).bfloat16()
        out = w8a8_linear(x, w8, so, bias, act)
        ref = w8a8_linear_plain(x, w8, so, bias, act)
        torch.cuda.synchronize()
        abs_err, rel_err = errors(out, ref)
        del out, ref
        if (act is None and abs_err != 0.0) or rel_err > 1e-2:
            raise AssertionError(f"w8a8 [{m},{k}]->{n} act={act}: max abs "
                                 f"error {abs_err}, rel {rel_err}")
        ms = graph_ms(lambda: w8a8_linear(x, w8, so, bias, act), 20)
        eager_ms = cuda_ms(lambda: w8a8_linear(x, w8, so, bias, act), 20)
        quant_ms = graph_ms(lambda: w8a8_prepass(x), 20)
        plain_ms = cuda_ms(lambda: w8a8_linear_plain(x, w8, so, bias, act), 3)
        xq = quantize_rows(x)[0]
        if m < 32:
            xq = torch.nn.functional.pad(xq, (0, 0, 0, 32 - m))
        wt = w8.contiguous().t()
        lib_ms = graph_ms(lambda: torch._int_mm(xq, wt), 20)
        ops = 2 * m * n * k
        nbytes = m * k * 2 + n * k + m * n * 2 + n * 4 + n * 2
        bound_ms, by = bound(0, nbytes, int8_ops=ops)
        plan = plan_w8a8(m, n, k,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count)
        phase("kernel", name="w8a8_linear", shape=f"[{m},{k}]->{n}bf16",
              act=act, w_row_stride=w8.stride(0),
              plan=f"{plan.bm}x{plan.bn}/split{plan.split}/grid{plan.grid}",
              max_abs_err=abs_err, tol="exact (no act), rel 1e-2",
              kernel_ms=ms, eager_ms=eager_ms, quant_ms=quant_ms,
              plain_ms=plain_ms,
              library_ms=lib_ms, bound_ms=bound_ms, bound_by=by,
              tops=ops / ms / 1e9, card=smi)
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
    decode tile); the last gives the timed entry. B11 (conv3d_stride1_v2,
    the temporal-reuse kernel) on the same inputs against the same plain
    version, with K3's time beside its own; B11's entry comes from
    check_conv_v2, at the shapes of the path that runs it."""
    g = torch.Generator(dev).manual_seed(1)
    worst = 0.0
    for shape in ((1, 9, 64, 64, 128, 128), (1, 9, 32, 32, 512, 512),
                  (1, 33, 256, 256, 128, 128)):
        b, t, hh, ww, cin, cout = shape
        x = torch.randn(b, t, hh, ww, cin, generator=g, device=dev).half()
        xp = replicate_pad(x, (2, 0), (1, 1), (1, 1))
        w = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
             / math.sqrt(27 * cin)).half()
        bias = torch.randn(cout, generator=g, device=dev).half()
        ref = conv3d_stride1_plain(xp, w, bias)
        abs_err = {}
        for fn in (conv3d_stride1, conv3d_stride1_v2):
            out = fn(xp, w, bias)
            torch.cuda.synchronize()
            abs_err[fn.__name__], rel_err = errors(out, ref)
            if rel_err > 5e-3:
                raise AssertionError(f"{fn.__name__} {shape}: max rel error "
                                     f"{rel_err} > 5e-3")
            del out
        del ref
        flops = 2 * 27 * cin * cout * b * t * hh * ww
        nbytes = (xp.numel() + w.numel() + b * t * hh * ww * cout) * 2 \
            + cout * 2
        ms = cuda_ms(lambda: conv3d_stride1(xp, w, bias), 10)
        v2_ms = cuda_ms(lambda: conv3d_stride1_v2(xp, w, bias), 10)
        plain_ms = cuda_ms(lambda: conv3d_stride1_plain(xp, w, bias), 2)
        x_ncdhw = xp.permute(0, 4, 1, 2, 3)
        w_oi = w.permute(4, 3, 0, 1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv3d(x_ncdhw, w_oi,
                                                            bias), 10)
        bound_ms, by = bound(flops, nbytes)
        shape_s = f"[{b},{t},{hh},{ww},{cin}]->{cout}fp16"
        phase("kernel", name="conv3d_stride1", shape=shape_s,
              max_abs_err=abs_err["conv3d_stride1"], tol="rel 5e-3 (fp16)",
              kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
              bound_ms=bound_ms, tflops=flops / ms / 1e9, card=smi)
        phase("kernel", name="conv3d_stride1_v2", shape=shape_s,
              max_abs_err=abs_err["conv3d_stride1_v2"],
              tol="rel 5e-3 (fp16)",
              kernel_ms=v2_ms, k3_ms=ms, plain_ms=plain_ms,
              library_ms=lib_ms, bound_ms=bound_ms,
              tflops=flops / v2_ms / 1e9, card=smi)
        worst = max(worst, abs_err["conv3d_stride1"])
        row = dict(name="conv3d_stride1", route="cuda",
                   source=SRC + "conv3d.cu",
                   replaces=f"{JAX}conv3d_pallas.py:50", max_abs_err=worst,
                   ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                   library_ms=lib_ms)
        del xp, x, x_ncdhw
    return [row]


def check_conv_decode(dev, smi):
    """K3 and F.conv3d (fp16, with a bias, on the padded input as
    causal_conv3d gives it) at each distinct K3 shape of the dense main
    path's decode (conv_probe.decode_k3_shapes at 256x448x33), one timed
    call each, with that shape's launch count: where the decode's conv time
    goes, weighted by launches. A timing, not a check."""
    g = torch.Generator(dev).manual_seed(3)
    shapes = conv_probe.decode_k3_shapes(HEIGHT, WIDTH, FRAMES)
    k3_total = lib_total = bound_total = 0.0
    for (b, t, hh, ww, cin, cout), n in shapes.items():
        xp = torch.randn(b, t + 2, hh + 2, ww + 2, cin, generator=g,
                         device=dev).half()
        w = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
             / math.sqrt(27 * cin)).half()
        bias = torch.randn(cout, generator=g, device=dev).half()
        ms = cuda_ms(lambda: conv3d_stride1(xp, w, bias), 1)
        x_ncdhw = xp.permute(0, 4, 1, 2, 3)
        w_oi = w.permute(4, 3, 0, 1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv3d(x_ncdhw, w_oi,
                                                            bias), 1)
        flops = 2 * 27 * cin * cout * b * t * hh * ww
        nbytes = (xp.numel() + w.numel() + b * t * hh * ww * cout) * 2 \
            + cout * 2
        bound_ms, _ = bound(flops, nbytes)
        k3_total += n * ms
        lib_total += n * lib_ms
        bound_total += n * bound_ms
        phase("conv_decode", shape=f"[{b},{t},{hh},{ww},{cin}]->{cout}fp16",
              launches=n, kernel_ms=ms, library_ms=lib_ms, bound_ms=bound_ms,
              tflops=flops / ms / 1e9, card=smi)
        del xp, x_ncdhw, w, w_oi
    phase("conv_decode_total", shapes=len(shapes),
          launches=sum(shapes.values()), kernel_ms=k3_total,
          library_ms=lib_total, bound_ms=bound_total, card=smi)


def check_conv_v2(dev, smi):
    """B11 at the shapes of the path that runs it, the conv probe's three
    decoder stages (conv_probe.SHAPES, bf16, no bias), on the input padded as
    conv_probe.v2_conv pads it: against conv3d_stride1_plain, max relative
    error 1e-2 (bf16: one rounding step of the largest output is up to 2^-7
    of it), and equal to K3 bit for bit (both sum the taps in the same
    order). The first, largest shape gives the timed entry, with K3's time
    beside B11's."""
    g = torch.Generator(dev).manual_seed(2)
    row = None
    for t, hh, ww, cin, cout in conv_probe.SHAPES:
        x = torch.randn(1, t, hh, ww, cin, generator=g, device=dev).bfloat16()
        xp = replicate_pad(x, (2, 0), (1, 1), (1, 1))
        del x
        w = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
             * 0.02).bfloat16()
        out = conv3d_stride1_v2(xp, w)
        abs_err, rel_err = errors(out, conv3d_stride1_plain(xp, w))
        k3_diff = (out.float() - conv3d_stride1(xp, w).float()).abs().max()
        torch.cuda.synchronize()
        del out
        shape_s = f"[1,{t},{hh},{ww},{cin}]->{cout}bf16"
        if rel_err > 1e-2 or k3_diff.item() != 0:
            raise AssertionError(f"conv3d_stride1_v2 {shape_s}: max rel "
                                 f"error {rel_err} > 1e-2 or differs from "
                                 f"K3 by {k3_diff.item()}")
        fields = dict(max_abs_err=abs_err, max_rel_err=rel_err,
                      tol="rel 1e-2 (bf16), == K3", vs_k3_max_abs_diff=0.0)
        if row is None:
            flops = 2 * 27 * cin * cout * t * hh * ww
            nbytes = (xp.numel() + w.numel() + t * hh * ww * cout) * 2
            ms = cuda_ms(lambda: conv3d_stride1_v2(xp, w), 10)
            k3_ms = cuda_ms(lambda: conv3d_stride1(xp, w), 10)
            plain_ms = cuda_ms(lambda: conv3d_stride1_plain(xp, w), 2)
            x_ncdhw = xp.permute(0, 4, 1, 2, 3)
            w_oi = w.permute(4, 3, 0, 1, 2).contiguous()
            lib_ms = cuda_ms(lambda: torch.nn.functional.conv3d(x_ncdhw,
                                                                w_oi), 10)
            bound_ms, by = bound(flops, nbytes)
            fields.update(kernel_ms=ms, k3_ms=k3_ms, plain_ms=plain_ms,
                          library_ms=lib_ms, bound_ms=bound_ms,
                          tflops=flops / ms / 1e9)
            row = dict(name="conv3d_stride1_v2", route="cuda",
                       source=SRC + "conv3d_v2.cu",
                       replaces=f"{JAX}conv3d_pallas.py:136",
                       max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=by, library_ms=lib_ms)
            del x_ncdhw, w_oi
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        phase("kernel", name="conv3d_stride1_v2", shape=shape_s, **fields,
              card=smi)
        del xp, w
    return [row]


def sta_inputs(dev, seed):
    """The STA phases' inputs at 540p: RMS-normalized q/k (as after the
    DiT's QK-norm with unit scales), random v, 256 text keys of which the
    first 40 are valid, and C from the DiT's analytic bound."""
    g = torch.Generator(dev).manual_seed(seed)
    b, h, d, lt = 2, 24, 128, 256
    s = STA_GRID[0] * STA_GRID[1] * STA_GRID[2]
    img = (rms_normed(g, dev, b, s, h, d), rms_normed(g, dev, b, s, h, d),
           torch.randn(b, s, h, d, generator=g, device=dev).bfloat16())
    txt = (rms_normed(g, dev, b, lt, h, d), rms_normed(g, dev, b, lt, h, d),
           torch.randn(b, lt, h, d, generator=g, device=dev).bfloat16())
    tb = torch.zeros(b, 1, 1, lt, device=dev)
    tb[..., 40:] = -1e30
    return img, txt, tb, analytic_bound(dev, b, h, d)


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
        source = "sta_direct.cu" if name == "sta_direct" else \
            "sta_permuted.cu"
        rows.append(dict(
            name=name, route="cuda", source=SRC + source,
            replaces=f"hunyuanvideo_efficiency_tpu/ops/sta.py:{line}",
            max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=by, library_ms=lib_ms))
    time_sta_headline(dev, smi)
    return rows


def time_sta_headline(dev, smi):
    """One timed sta_direct launch at the reference's headline shape,
    720x1280x129f: [2, 118800, 24, 128] bf16 on the 33x45x80 patch grid,
    tile (4, 8, 8), window (3, 3, 3), 256 text keys of which 40 are valid,
    RMS-normalized q/k, C from the analytic bound. A timing, not a check:
    no plain version runs at that size (the output is only checked finite;
    B4's correctness is check_sta's 540p check). Bound: 4*D operations per
    valid query-key pair (sta_pair_count)."""
    g = torch.Generator(dev).manual_seed(7)
    b, h, d, lt, valid = 2, 24, 128, 256, 40
    grid = (33, 45, 80)
    s = grid[0] * grid[1] * grid[2]
    q, k, tk = (rms_normed(g, dev, b, n, h, d) for n in (s, s, lt))
    v, tv = (torch.randn(b, n, h, d, generator=g, device=dev).bfloat16()
             for n in (s, lt))
    tb = torch.zeros(b, 1, 1, lt, device=dev)
    tb[..., valid:] = -1e30
    c = analytic_bound(dev, b, h, d)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = sta_direct(q, k, v, tk, tv, tb, c, grid, STA_TILE, STA_WINDOW,
                     d ** -0.5)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    if out.shape != (b, s, h * d) or not torch.isfinite(out).all():
        raise AssertionError("sta_direct at the headline shape: output not "
                             "finite or of the wrong shape")
    pairs = sta_pair_count(grid, STA_TILE, STA_WINDOW, valid)
    flops = 4 * d * h * b * pairs
    bound_ms, by = bound(flops, 4 * q.numel() * 2 + 2 * tk.numel() * 2)
    phase("headline", name="sta_direct", shape=f"[{b},{s},{h},{d}]bf16",
          grid=json.dumps(grid), tile=json.dumps(STA_TILE),
          window=json.dumps(STA_WINDOW), text_keys=f"{lt}({valid} valid)",
          pairs_per_head=pairs, kernel_ms=ms, bound_ms=bound_ms,
          bound_by=by, tflops=flops / ms / 1e9,
          check="timing only (finite output)", card=smi)
    del q, k, v, out
    torch.cuda.empty_cache()


def check_sta_int8(dev, smi, lib_ms):
    """The quant arms of B4 and B6 at the 540p inputs of check_sta, C
    inflated for int8 rounding, each against its plain version (the direct
    arm's text keys in bf16, the permuted arm's quantized), max relative
    error 2e-2; each with its quantizing pre-pass alone (quant_ms, part of
    kernel_ms). Yardstick: the masked SDPA of check_sta. Bound: the image
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
                                     window, scale, c, qk_int8=True),
         lambda: sta_tile_codes(iq, ik, grid, tile)),
        ("sta_permuted_static_int8", 446, pairs,
         lambda: sta_permuted_static_int8(qp, kcat, vcat, kb, c, grid, tile,
                                          window, scale),
         lambda: sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                    scale, c, qk_int8=True),
         lambda: sta_permuted_codes(qp, kcat, tile)))
    rows = []
    for name, line, int8_pairs, fn, plain, prepass in kernels:
        out, ref = fn(), plain()
        torch.cuda.synchronize()
        abs_err, rel_err = errors(out, ref)
        del out, ref
        if rel_err > 2e-2:
            raise AssertionError(f"{name}: max rel error {rel_err} > 2e-2")
        ms = cuda_ms(fn, 5)
        quant_ms = cuda_ms(prepass, 5)
        plain_ms = cuda_ms(plain, 2)
        bound_ms, by = bound(per_pair * (2 * pairs - int8_pairs), io_bytes,
                             int8_ops=per_pair * int8_pairs)
        phase("kernel", name=name, shape=f"[{b},{s},{h},{d}]bf16",
              grid=json.dumps(grid), tile=json.dumps(tile),
              text_keys=f"{lt}({txt_valid} valid)", max_abs_err=abs_err,
              tol="rel 2e-2 (bf16)", kernel_ms=ms, quant_ms=quant_ms,
              plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
              card=smi)
        rows.append(dict(
            name=name, route="cuda",
            source=SRC + ("sta_direct.cu" if name == "sta_direct_int8"
                          else "sta_permuted.cu"),
            replaces=f"{JAX}sta.py:{line}", max_abs_err=abs_err, ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
            library_ms=lib_ms))
    return rows


def check_sta_ring(dev, smi, lib_ms):
    """B10 at the 540p inputs of check_sta, on its own operands (q5 a view
    of the row-major queries, K/V copied to w-major order), against
    sta_ring_plain and against sta_direct (B4, the same function) on the
    same inputs, max relative error 2e-2 each; the bound is B4's (the same
    valid pairs), the yardstick check_sta's masked SDPA; sta_direct is timed
    on the same inputs in the same call, before and after."""
    (iq, ik, iv), (_, tk, tv), tb, c = sta_inputs(dev, 11)
    b, s, h, d = iq.shape
    lt, txt_valid = tk.shape[1], 40
    grid, tile, window, scale = STA_GRID, STA_TILE, STA_WINDOW, d ** -0.5
    pg = _padded_grid(grid, tile)
    args = (iq.reshape(b, *grid, h * d),
            _permute_tokens_cols(ik, grid, tile, pg),
            _permute_tokens_cols(iv, grid, tile, pg),
            tk.reshape(b, lt, h * d), tv.reshape(b, lt, h * d),
            tb.reshape(b, lt), c, grid, tile, window, scale)
    pairs = sta_pair_count(grid, tile, window, txt_valid)
    bound_ms, by = bound(4 * d * h * b * pairs,
                         4 * iq.numel() * 2 + 2 * tk.numel() * 2)

    def direct():
        return sta_direct(iq, ik, iv, tk, tv, tb, c, grid, tile, window,
                          scale)

    out, ref = sta_ring(*args), sta_ring_plain(*args)
    torch.cuda.synchronize()
    abs_err, rel_err = errors(out, ref)
    direct_err = errors(out.reshape(b, s, h * d), direct())[1]
    del out, ref
    if rel_err > 2e-2 or direct_err > 2e-2:
        raise AssertionError(f"sta_ring: max rel error {rel_err} (plain), "
                             f"{direct_err} (sta_direct) > 2e-2")

    direct_ms = [cuda_ms(direct, 5)]
    ms = cuda_ms(lambda: sta_ring(*args), 5)
    direct_ms.append(cuda_ms(direct, 5))
    plain_ms = cuda_ms(lambda: sta_ring_plain(*args), 2)
    phase("kernel", name="sta_ring", shape=f"[{b},{s},{h},{d}]bf16",
          grid=json.dumps(grid), tile=json.dumps(tile),
          window=json.dumps(window), text_keys=f"{lt}({txt_valid} valid)",
          pairs_per_head=pairs, max_abs_err=abs_err, tol="rel 2e-2 (bf16)",
          rel_err_vs_sta_direct=direct_err,
          kernel_ms=ms, sta_direct_ms=json.dumps(direct_ms),
          plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
          tflops=4 * d * h * b * pairs / ms / 1e9, card=smi)
    return [dict(name="sta_ring", route="cuda",
                 source=SRC + "sta_direct.cu",
                 replaces=f"{JAX}sta.py:950", max_abs_err=abs_err, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by,
                 library_ms=lib_ms)]


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
    expect("running-max path's decode", launches,
           dict(conv3d_stride1=decode_k3_launches((FRAMES, HEIGHT, WIDTH))))
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
    expect("STA main path", launches, want)
    return sampler, launches, r["out"]["samples"]


def sta_ring_path(sampler, direct_video, smi):
    """The same predict() (sta_main_path's sampler, seed and size) under
    set_sta_ring(True): the ring kernel in the 58 STA blocks, none of
    sta_direct; the switch goes back to False even on failure. The video's
    mean absolute difference to sta_main_path's (the same function through
    the other kernel) is reported."""
    set_sta_ring(True)
    try:
        reset_counts()
        r = timed_predict(sampler,
                          "A cat walks on the grass, realistic style.",
                          (STA_FRAMES, STA_HEIGHT, STA_WIDTH), STA_STEPS, 42)
    finally:
        set_sta_ring(False)
    diff = (r["out"]["samples"].float() - direct_video.float()).abs().mean()
    phase("sta_ring_path", size=f"{STA_HEIGHT}x{STA_WIDTH}x{STA_FRAMES}",
          steps=STA_STEPS, switch="set_sta_ring(True)",
          s_per_step=r["s_per_step"], first_step_s=r["first_step_s"],
          decode_s=r["decode_s"], gen_s=r["gen_s"],
          max_memory_allocated_gb=r["max_memory_allocated_gb"],
          video_mean_abs_diff_vs_sta_direct=diff.item(),
          launches=json.dumps(r["launches"]),
          per_step=json.dumps(r["per_step"]), card=smi)
    per_step = dict(sta_ring=58, sta_direct=0, flash_static=2 + 2 * 58)
    for step in r["per_step"]:
        expect("STA ring path step", step, per_step)
    expect("STA ring path", r["launches"],
           {k: n * STA_STEPS for k, n in per_step.items()})
    return r["launches"]


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
    expect("STA running path's decode", launches, dict(
        conv3d_stride1=decode_k3_launches((STA_FRAMES, STA_HEIGHT,
                                           STA_WIDTH))))
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


@functools.lru_cache(maxsize=None)
def decode_k3_launches(size):
    """K3's launches in one tiled decode of a frames x height x width video
    (conv_probe.decode_k3_shapes: the decoder on meta tensors)."""
    frames, height, width = size
    return sum(conv_probe.decode_k3_shapes(height, width, frames).values())


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
    expect(f"decode at {height}x{width}x{frames}", read_counts(),
           dict(conv3d_stride1=decode_k3_launches(size)))
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


def conv_probe_path(smi):
    """The conv probe's main (probes/conv_probe.py) at its three decoder
    stages, one timed call each: F.conv3d, K3 and B11 after its numerics
    check; B11's launch count comes from here."""
    reset_counts()
    results = conv_probe.main(reps=1)
    launches = read_counts()
    phase("conv_probe", results=json.dumps(results),
          launches=json.dumps({k: n for k, n in launches.items() if n}),
          card=smi)
    if launches["conv3d_stride1_v2"] == 0 or launches["conv3d_stride1"] == 0:
        raise AssertionError(f"conv probe launches {launches}: expected K3 "
                             f"and B11")
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
        if not cfg.qk_norm:
            continue
        # the ring arm: gh = 4 >= wh, so every STA block takes sta_ring
        set_sta_ring(True)
        try:
            reset_counts()
            with torch.no_grad():
                out = model(x, t, txt, mask, txt2, cos, sin).float()
            launches = read_counts()
        finally:
            set_sta_ring(False)
        diff = ((out - ref).norm() / ref.norm()).item()
        finite = bool(torch.isfinite(out).all())
        phase("sta_reference", model=label, grid=json.dumps(grid),
              arm="set_sta_ring(True)",
              check="the ring kernel vs sta_attention_plain", rel_l2=diff,
              tol=5e-2, finite=finite, launches=json.dumps(launches))
        if not finite or diff > 5e-2:
            raise AssertionError(f"{label}: the ring arm disagrees with the "
                                 f"plain version: rel L2 {diff}")
        expect(f"{label} ring arm", launches, dict(sta_ring=4, sta_direct=0))


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


def train_batch(dev, cfg, latent, seed, txt_len=256, txt_valid=40):
    """One fixed training batch: a [1, *latent] clean latent and noise,
    t = 0.5, `txt_len` text tokens of which `txt_valid` are valid, the
    pooled text vector and the grid RoPE tables; also the patch grid."""
    g = torch.Generator(dev).manual_seed(seed)
    x0 = torch.randn(1, *latent, generator=g, device=dev)
    noise = torch.randn(1, *latent, generator=g, device=dev)
    t = torch.full((1,), 0.5, device=dev)
    pe = torch.randn(1, txt_len, cfg.text_states_dim, generator=g,
                     device=dev)
    mask = torch.ones(1, txt_len, dtype=torch.long, device=dev)
    mask[:, txt_valid:] = 0
    pe2 = torch.randn(1, cfg.text_states_dim_2, generator=g, device=dev)
    grid = (latent[1] // cfg.patch_size[0], latent[2] // cfg.patch_size[1],
            latent[3] // cfg.patch_size[2])
    cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, grid,
                                       theta=cfg.rope_theta, device=dev)
    return (x0, noise, t, pe, mask, pe2, cos.reshape(*grid, -1),
            sin.reshape(*grid, -1)), grid


def train_setup(dev, latent, seed, **cfg):
    """A trainable bf16 DiT at the full width of HYVideo-T/2 (cfg overrides
    cut the depth or set attn_mode), its zero-initialized adaLN and final
    layers randomized, and one fixed batch of `train_batch`."""
    cfg = dataclasses.replace(DiTConfig(), **cfg)
    model = dit_mod.build_dit(cfg, dev, torch.bfloat16,
                              torch.Generator(dev).manual_seed(seed),
                              trainable=True)
    randomize_modulation(model, seed + 1)
    batch, grid = train_batch(dev, cfg, latent, seed + 2)
    return model, batch, grid


def watch_grads(params):
    """Hooks that record each watched parameter's gradient norm and
    finiteness as it is computed (the train steps free the gradients).
    Returns ({name: [norm, ...]}, remove)."""
    seen, handles = {}, []
    for name, p in params.items():
        def hook(grad, name=name):
            seen.setdefault(name, []).append(grad.float().norm().item())
        handles.append(p.register_hook(hook))
    return seen, lambda: [h.remove() for h in handles]


def train_path(dev, smi):
    """SGD steps of make_train_step at full width and depth on a fixed
    batch; launch counts per step, loss, the first block's qkv gradient,
    peak memory and seconds per step."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    model, batch, grid = train_setup(dev, TRAIN_LATENT, 20)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    n_blocks = len(model.double_blocks) + len(model.single_blocks)
    step = make_train_step(model, lr=TRAIN_LR)
    qkv = "double_blocks.0.img_attn_qkv.weight"
    seen, remove = watch_grads({qkv: model.get_parameter(qkv)})
    reset_counts()
    losses, secs, per_step, before = [], [], [], read_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.time()
        losses.append(step(*batch).item())
        torch.cuda.synchronize()
        secs.append(time.time() - t0)
        now = read_counts()
        per_step.append({k: now[k] - before[k] for k in now if now[k]})
        before = now
    remove()
    launches = read_counts()
    phase("train_path", blocks=f"{len(model.double_blocks)}+"
          f"{len(model.single_blocks)}", remat=True, dtype="bf16",
          dit_params=sum(p.numel() for p in model.parameters()),
          tokens=f"{grid[0] * grid[1] * grid[2]}+256", optimizer="sgd",
          lr=TRAIN_LR, losses=json.dumps(losses),
          qkv_grad_norm=json.dumps(seen[qkv]),
          build_s=build_s, first_step_s=secs[0],
          s_per_step=statistics.median(secs[1:]),
          step_seconds=json.dumps(secs),
          max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
          per_step=json.dumps(per_step), card=smi)
    want = dict(flash_static=n_blocks, flash_fwd_lse=n_blocks,
                flash_bwd_dq=n_blocks, flash_bwd_dkv=n_blocks)
    for got in per_step:
        if got != want:
            raise AssertionError(f"train step launches {got}, expected "
                                 f"{want}")
    if not all(math.isfinite(x) for x in losses) \
            or not losses[1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite or not "
                             f"lower at step 2")
    if len(seen[qkv]) != TRAIN_STEPS or not all(
            math.isfinite(n) and n > 0 for n in seen[qkv]):
        raise AssertionError(f"first block's qkv gradient norms {seen[qkv]}")
    return launches


def train_adamw_path(dev, smi):
    """make_train_step_adamw at full width and reduced depth: the master,
    Adam moments and EMA cost about 20 bytes a parameter."""
    torch.cuda.reset_peak_memory_stats()
    blocks = ADAMW_BLOCKS
    model, batch, _ = train_setup(dev, TRAIN_LATENT, 30,
                                  mm_double_blocks_depth=blocks[0],
                                  mm_single_blocks_depth=blocks[1])
    step, init_fn = make_train_step_adamw(model, lr=ADAMW_LR,
                                          weight_decay=1e-4, grad_clip=1.0,
                                          ema_decay=0.99)
    state = init_fn()
    reset_counts()
    losses, secs = [], []
    for _ in range(ADAMW_STEPS):
        t0 = time.time()
        state, loss = step(state, *batch)
        losses.append(loss.item())
        secs.append(time.time() - t0)
    rounded = all(torch.equal(p.detach(), state["master"][n].bfloat16())
                  for n, p in model.named_parameters())
    ema_gap = max((state["ema"][n] - m).abs().max().item()
                  for n, m in state["master"].items())
    ema_finite = all(bool(torch.isfinite(e).all())
                     for e in state["ema"].values())
    launches = {k: n for k, n in read_counts().items() if n}
    phase("train_adamw_path", blocks=f"{blocks[0]}+{blocks[1]}",
          dit_params=sum(p.numel() for p in model.parameters()),
          optimizer="adamw + clip 1.0 + ema 0.99, fp32 master", lr=ADAMW_LR,
          losses=json.dumps(losses), step=state["step"],
          params_are_rounded_master=rounded, ema_master_max_gap=ema_gap,
          ema_finite=ema_finite, s_per_step=statistics.median(secs[1:]),
          step_seconds=json.dumps(secs),
          max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
          launches=json.dumps(launches), card=smi)
    n = (blocks[0] + blocks[1]) * ADAMW_STEPS
    expect("AdamW train path", read_counts(), dict(
        flash_static=n, flash_fwd_lse=n, flash_bwd_dq=n, flash_bwd_dkv=n))
    if not all(math.isfinite(x) for x in losses) \
            or not losses[-1] < losses[0]:
        raise AssertionError(f"AdamW losses {losses}: not finite or not "
                             f"falling")
    if not rounded or not ema_finite or not ema_gap > 0 \
            or state["step"] != ADAMW_STEPS:
        raise AssertionError("AdamW state: parameters are not the rounded "
                             "master, or the EMA is not a finite trailing "
                             "average, or the step count is off")


def train_sta_path(dev, smi):
    """One SGD step of a 2+2-block full-width DiT under attn_mode="sta":
    sta_direct in the no-grad forward and in the recomputation of every
    block (K1 twice per forward for the text queries), the backward through
    sta_gathered_attention."""
    model, batch, grid = train_setup(dev, STA_TRAIN_LATENT, 40,
                                     attn_mode="sta",
                                     mm_double_blocks_depth=2,
                                     mm_single_blocks_depth=2)
    step = make_train_step(model, lr=TRAIN_LR)
    seen, remove = watch_grads(dict(model.named_parameters()))
    reset_counts()
    loss = step(*batch).item()
    torch.cuda.synchronize()
    remove()
    launches = {k: n for k, n in read_counts().items() if n}
    norms = [n for ns in seen.values() for n in ns]
    block_names = [n for n in seen if "_blocks." in n]
    phase("train_sta_path", blocks="2+2", grid=json.dumps(grid),
          tile=json.dumps(STA_TILE), loss=loss, params_with_grad=len(seen),
          min_block_grad_norm=min(min(seen[n]) for n in block_names),
          max_grad_norm=max(norms), launches=json.dumps(launches), card=smi)
    expect("STA train path", read_counts(), dict(
        sta_direct=8, flash_static=16, flash_fwd_lse=0, flash_bwd_dq=0))
    n_params = sum(1 for _ in model.parameters())
    if not math.isfinite(loss) or len(seen) != n_params \
            or not all(math.isfinite(n) for n in norms) \
            or not all(min(seen[n]) > 0 for n in block_names):
        raise AssertionError(f"STA train step: loss {loss}, {len(seen)} of "
                             f"{n_params} parameters got a gradient, norms "
                             f"finite and non-zero in the blocks?")


def train_entry_path(smi):
    """The `train` entry as a user calls it (train.main: the dataset
    loader, the CPU generator's draws, the optimizer, the checkpoint writer
    and --resume), on the card at full width, twice: with `--optimizer sgd`
    at the full depth (ENTRY_STEPS steps and a checkpoint), and with the
    default AdamW + master + EMA at ENTRY_BLOCKS depth (ENTRY_STEPS steps
    and a checkpoint, then a resumed run to twice that)."""
    from hunyuanvideo_efficiency_tpu_torch import train as train_cli
    from hunyuanvideo_efficiency_tpu_torch.data.dataset_loader import (
        save_tensor)
    from hunyuanvideo_efficiency_tpu_torch.utils.checkpoint import (
        load_torch_state_dict)
    from hunyuanvideo_efficiency_tpu_torch.utils.train_io import load_tree

    names = ("flash_static", "flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv")
    root = tempfile.mkdtemp(prefix="hv_train_entry_")
    try:
        data = os.path.join(root, "latents")
        os.makedirs(data)
        g = torch.Generator().manual_seed(60)
        for i in range(2):
            save_tensor(os.path.join(data, f"clip{i}.pt"),
                        torch.randn(*TRAIN_LATENT, generator=g))

        # the full depth on one card: bf16 weights and gradients only
        torch.cuda.reset_peak_memory_stats()
        out = os.path.join(root, "run_sgd")
        reset_counts()
        t0 = time.time()
        losses = train_cli.main([
            "--data-dir", data, "--latents", "--output-dir", out,
            "--optimizer", "sgd", "--lr", "1e-2", "--seed", "61", "--steps",
            str(ENTRY_STEPS)])
        torch.cuda.synchronize()
        seconds = time.time() - t0
        ck = os.path.join(out, f"step_{ENTRY_STEPS:07d}")
        files = sorted(os.listdir(ck))
        module_gb = os.path.getsize(os.path.join(ck, "module")) / 2**30
        shutil.rmtree(out)
        want = {name: 60 * ENTRY_STEPS for name in names}
        phase("train_entry_path",
              entry="hunyuanvideo_efficiency_tpu_torch.train",
              blocks="20+40", optimizer="sgd", losses=json.dumps(losses),
              run_seconds=seconds, files=json.dumps(files),
              module_gb=module_gb, max_memory_allocated_gb=(
                  torch.cuda.max_memory_allocated() / 2**30),
              launches=json.dumps(want), card=smi)
        expect("train entry, sgd at full depth", read_counts(), want)
        if len(losses) != ENTRY_STEPS \
                or not all(math.isfinite(x) for x in losses) \
                or files != ["meta.json", "module"] or module_gb < 23.8:
            raise AssertionError(f"train entry, sgd: losses {losses}, "
                                 f"files {files}, module {module_gb} GiB")
        gc.collect()
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        want = {name: sum(ENTRY_BLOCKS) * ENTRY_STEPS for name in names}
        out = os.path.join(root, "run")
        common = ["--data-dir", data, "--latents", "--output-dir", out,
                  "--blocks", *map(str, ENTRY_BLOCKS), "--lr", "1e-4",
                  "--ema-decay", "0.99", "--seed", "61"]
        runs = []
        for steps, extra in (
                (ENTRY_STEPS, []),
                (2 * ENTRY_STEPS, ["--resume", os.path.join(
                    out, f"step_{ENTRY_STEPS:07d}")])):
            reset_counts()
            t0 = time.time()
            losses = train_cli.main(common + ["--steps", str(steps)] + extra)
            torch.cuda.synchronize()
            runs.append(dict(losses=losses, seconds=time.time() - t0))
            expect(f"train entry to step {steps}", read_counts(), want)
            if len(losses) != ENTRY_STEPS \
                    or not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"train entry losses {losses}")
        ck = os.path.join(out, f"step_{2 * ENTRY_STEPS:07d}")
        files = {}
        for sub in (f"step_{ENTRY_STEPS:07d}", f"step_{2 * ENTRY_STEPS:07d}"):
            for name in ("module", "ema", "opt_state", "master", "meta.json"):
                files[f"{sub}/{name}"] = os.path.getsize(
                    os.path.join(out, sub, name))
        with open(os.path.join(ck, "meta.json")) as f:
            meta = json.load(f)
        module = load_torch_state_dict(os.path.join(ck, "module"), "module")
        master = load_tree(os.path.join(ck, "master"))
        count = load_tree(os.path.join(ck, "opt_state"))["count"]
        rounded = set(module) == set(master) and all(
            module[n].dtype == torch.bfloat16
            and torch.equal(module[n], master[n].bfloat16()) for n in module)
        moved = sum(1 for n, e in load_tree(os.path.join(ck, "ema")).items()
                    if not torch.equal(e, master[n]))
    finally:
        shutil.rmtree(root)
    phase("train_entry_path", entry="hunyuanvideo_efficiency_tpu_torch.train",
          blocks=f"{ENTRY_BLOCKS[0]}+{ENTRY_BLOCKS[1]}", optimizer="adamw",
          dit_params=sum(t.numel() for t in module.values()),
          losses=json.dumps([r["losses"] for r in runs]),
          run_seconds=json.dumps([r["seconds"] for r in runs]),
          checkpoint_gb=sum(files.values()) / 2 / 2**30, meta=json.dumps(meta),
          opt_count=count, module_is_rounded_master=rounded,
          ema_tensors_moved=moved,
          max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 2**30,
          launches_per_run=json.dumps(want), card=smi)
    if meta["step"] != 2 * ENTRY_STEPS or count != 2 * ENTRY_STEPS \
            or not rounded or not moved:
        raise AssertionError("train entry: the resumed checkpoint's step, "
                             "optimizer count, rounded master or EMA is off")


def harness_video(g):
    """A smooth video [3, F, H, W] in [-1, 1] drawn from `g` on its device:
    low-frequency noise upsampled trilinearly, so that frames have
    structure for SSIM to see."""
    low = torch.randn(1, 3, 5, 8, 14, generator=g, device=g.device)
    v = torch.nn.functional.interpolate(
        low, size=(HARNESS_FRAMES, HARNESS_HEIGHT, HARNESS_WIDTH),
        mode="trilinear", align_corners=False)[0]
    return torch.tanh(v)


def write_harness_videos(root, dev):
    """HARNESS_VIDEOS seeded harness_video()s as `.pt`."""
    g = torch.Generator(dev).manual_seed(70)
    os.makedirs(root)
    for i in range(HARNESS_VIDEOS):
        torch.save(harness_video(g).cpu(), os.path.join(root, f"clip{i}.pt"))


def write_harness_configs(root):
    """The sweep's four t-ops configs, in the t_ops_config.json schema:
    all off (the repo's t_ops_config.json), the first `pool` and the first
    `stride` config of the enumeration, and one that only interpolates
    (after the last resnet of up block 1)."""
    interp = base_config()
    interp["decoder"]["up_blocks"][1]["enable_t_interp_after_block"][2] = \
        True
    paths = []
    for name, cfg in (("base", base_config()), ("interp_up1", interp)):
        paths.append(os.path.join(root, f"{name}.json"))
        with open(paths[-1], "w") as f:
            json.dump(cfg, f, indent=2)
    for mode in ("pool", "stride"):
        first = write_configs(os.path.join(root, mode), mode, cap=1)[0]
        paths.append(os.path.join(root, f"{mode}_1.json"))
        os.replace(first, paths[-1])
    return sorted(paths)


def check_harness_k3(dev, shapes, smi):
    """K3 against F.conv3d (fp16, with a bias, on the padded input as
    causal_conv3d gives it) at each distinct K3 shape of the harness's
    encodes and decodes, max relative error 5e-3 as in check_conv, one
    timed call of each; `shapes` maps a shape to the side(s) that run it.
    Returns {shape: (K3 ms, F.conv3d ms, bound ms)}."""
    g = torch.Generator(dev).manual_seed(71)
    out_ms = {}
    for (b, t, hh, ww, cin, cout), side in sorted(shapes.items()):
        xp = torch.randn(b, t + 2, hh + 2, ww + 2, cin, generator=g,
                         device=dev).half()
        w = (torch.randn(3, 3, 3, cin, cout, generator=g, device=dev)
             / math.sqrt(27 * cin)).half()
        bias = torch.randn(cout, generator=g, device=dev).half()
        x_ncdhw = xp.permute(0, 4, 1, 2, 3)
        w_oi = w.permute(4, 3, 0, 1, 2).contiguous()
        ref = torch.nn.functional.conv3d(x_ncdhw, w_oi, bias).permute(
            0, 2, 3, 4, 1)
        abs_err, rel_err = errors(conv3d_stride1(xp, w, bias), ref)
        if rel_err > 5e-3:
            raise AssertionError(f"K3 at the {side} shape {(b, t, hh, ww)} "
                                 f"{cin}->{cout}: max rel error {rel_err} "
                                 f"> 5e-3 against F.conv3d")
        ms = cuda_ms(lambda: conv3d_stride1(xp, w, bias), 1)
        lib_ms = cuda_ms(lambda: torch.nn.functional.conv3d(x_ncdhw, w_oi,
                                                            bias), 1)
        flops = 2 * 27 * cin * cout * b * t * hh * ww
        nbytes = (xp.numel() + w.numel() + b * t * hh * ww * cout) * 2 \
            + cout * 2
        bound_ms, _ = bound(flops, nbytes)
        out_ms[(b, t, hh, ww, cin, cout)] = (ms, lib_ms, bound_ms)
        phase("harness_k3", shape=f"[{b},{t},{hh},{ww},{cin}]->{cout}fp16",
              side=side, max_abs_err=abs_err, max_rel_err=rel_err,
              tol="rel 5e-3 vs F.conv3d", kernel_ms=ms, library_ms=lib_ms,
              bound_ms=bound_ms, tflops=flops / ms / 1e9, card=smi)
        del xp, x_ncdhw, w, w_oi, ref
    return out_ms


class VaeSpans:
    """Every Encoder and Decoder call while open (torch's global module
    forward hooks): its class name, CUDA events around it and the K3
    launches inside it. One Encoder call encodes one tile, one Decoder
    call decodes one."""

    def __enter__(self):
        from hunyuanvideo_efficiency_tpu_torch.models.vae import (
            Decoder, Encoder)

        self.kinds, self.calls, self.open = (Encoder, Decoder), [], None
        hooks = torch.nn.modules.module
        self.handles = (hooks.register_module_forward_pre_hook(self.enter),
                        hooks.register_module_forward_hook(self.leave))
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()

    def enter(self, module, args):
        if isinstance(module, self.kinds):
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.open = (start, conv3d_stride1.LAUNCHES)

    def leave(self, module, args, out):
        if isinstance(module, self.kinds):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            start, k3 = self.open
            self.calls.append((type(module).__name__, start, end,
                               conv3d_stride1.LAUNCHES - k3))

    def check(self, label, encode_tiles, decode_tiles):
        """Each call's K3 launches (20 an encode tile, 31 a decode tile)
        and the number of calls; returns the calls' milliseconds by side."""
        torch.cuda.synchronize()
        ms = {"Encoder": [], "Decoder": []}
        for kind, start, end, k3 in self.calls:
            if k3 != {"Encoder": 20, "Decoder": 31}[kind]:
                raise AssertionError(f"{label}: {k3} K3 launches in one "
                                     f"{kind} call; expected 20 an encode "
                                     f"tile, 31 a decode tile")
            ms[kind].append(start.elapsed_time(end))
        if (len(ms["Encoder"]), len(ms["Decoder"])) != (encode_tiles,
                                                        decode_tiles):
            raise AssertionError(f"{label}: {len(ms['Encoder'])} encode and "
                                 f"{len(ms['Decoder'])} decode calls; "
                                 f"expected {encode_tiles} and "
                                 f"{decode_tiles}")
        return ms


def harness_path(dev, smi):
    """The t-ops experiment harness as a user runs it: seeded 240x432x33
    `.pt` videos, four t-ops configs (write_harness_configs), each through
    the sweep's two steps on the card, run_experiment (the full-width
    884-16c-hy VAE in fp16, random weights from infer.RANDOM_INIT_SEED) and
    compute_metrics_dir (PSNR / SSIM / random-weight LPIPS), the ranking by
    PSNR, and the base config again through the `infer` entry with
    --enable-tiling. K3 launches exactly 20 times in every encode tile and
    31 times in every decode tile (counted on meta tensors by
    conv_probe.roundtrip_k3_shapes, and on the card in each Encoder and
    Decoder call, which CUDA events time). Then every K3 shape of those
    round trips against F.conv3d, each config's saved reconstruction of one
    video against the same weights in fp32 (F.conv3d: relative L2 within
    2e-2), and the base and pool configs' metrics on the CPU against the
    card's."""
    from hunyuanvideo_efficiency_tpu_torch import infer
    from hunyuanvideo_efficiency_tpu_torch.evaluation import (
        compute_metrics_dir, random_lpips_params)
    from hunyuanvideo_efficiency_tpu_torch.evaluation.lpips import (
        lpips_from_state_dict)
    from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
        TOpsConfig)

    size = (HARNESS_HEIGHT, HARNESS_WIDTH, HARNESS_FRAMES)
    root = tempfile.mkdtemp(prefix="hv_harness_")
    try:
        tensors, novae = os.path.join(root, "tensors"), os.path.join(
            root, "no_vae")
        write_harness_videos(tensors, dev)
        os.makedirs(os.path.join(root, "configs"))
        configs = write_harness_configs(os.path.join(root, "configs"))
        names = [os.path.splitext(os.path.basename(p))[0] for p in configs]
        plans = {n: conv_probe.roundtrip_k3_shapes(
            *size, TOpsConfig.from_json(p)) for n, p in zip(names, configs)}
        tiled_plan = conv_probe.roundtrip_k3_shapes(
            *size, TOpsConfig.from_json(configs[names.index("base")]),
            tiling=True)
        for n, (enc, dec, te, td) in [*plans.items(), ("tiled", tiled_plan)]:
            if (sum(enc.values()), sum(dec.values())) != (20 * te, 31 * td):
                raise AssertionError(f"{n}: K3 launches {sum(enc.values())} "
                                     f"in {te} encode tiles, "
                                     f"{sum(dec.values())} in {td} decode "
                                     f"tiles; expected 20 and 31 a tile")
        lpips_model = random_lpips_params(
            torch.Generator(dev).manual_seed(72), device=dev)

        out_base = os.path.join(root, "sweep")
        results, runs = [], {}
        for n, path in zip(names, configs):
            enc, dec, te, td = plans[n]
            out_dir = os.path.join(out_base, n)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            reset_counts()
            with VaeSpans() as spans:
                secs = run_experiment(path, tensors, out_dir, novae,
                                      random_init=True, device=dev)
            expect(f"harness {n}", read_counts(), dict(
                conv3d_stride1=HARNESS_VIDEOS * (sum(enc.values())
                                                 + sum(dec.values()))))
            ms = spans.check(n, HARNESS_VIDEOS * te, HARNESS_VIDEOS * td)
            peak = torch.cuda.max_memory_allocated()
            t0 = time.time()
            metrics = compute_metrics_dir(tensors, out_dir,
                                          lpips_params=lpips_model,
                                          device=dev)
            results.append(ExperimentResult(n, path, metrics, secs))
            runs[n] = dict(run_seconds=secs, metrics_seconds=time.time() - t0,
                           encode_ms=ms["Encoder"], decode_ms=ms["Decoder"],
                           peak_gib=peak / 2**30, held_before_gib=held / 2**30)
        ranked = rank_results(results, "psnr")
        phase("harness_sweep", configs=json.dumps(names),
              videos=HARNESS_VIDEOS, size="x".join(map(str, size)),
              seconds=sum(r.seconds for r in results),
              ranking=json.dumps([(r.name, r.metrics.mean_psnr)
                                  for r in ranked]), card=smi)

        enc, dec, te, td = tiled_plan
        reset_counts()
        t0 = time.time()
        with VaeSpans() as spans:
            infer.main(["--tensor-dir", tensors, "--output-dir",
                        os.path.join(root, "tiled"), "--config-json",
                        configs[names.index("base")], "--enable-tiling",
                        "--random-init", "--vae-path", novae, "--device",
                        str(dev)])
        torch.cuda.synchronize()
        tiled_s = time.time() - t0
        expect("harness tiled base", read_counts(), dict(
            conv3d_stride1=HARNESS_VIDEOS * (sum(enc.values())
                                             + sum(dec.values()))))
        tiled_ms = spans.check("tiled base", HARNESS_VIDEOS * te,
                               HARNESS_VIDEOS * td)

        shapes = {}
        for enc, dec, *_ in [*plans.values(), tiled_plan]:
            for side, seen in (("encode", enc), ("decode", dec)):
                for shape in seen:
                    both = shapes.get(shape, side) != side
                    shapes[shape] = "encode+decode" if both else side
        k3_ms = check_harness_k3(dev, shapes, smi)

        x = torch.load(os.path.join(tensors, "clip0.pt"),
                       weights_only=True)[None].to(dev)
        by_name = {r.name: r for r in results}
        for n, path in zip(names, configs):
            enc, dec, te, td = plans[n]
            vae32 = infer.load_vae("884-16c-hy", "fp32", novae, path,
                                   test=True, random_init=True,
                                   device=dev)[0]
            reset_counts()
            rec32 = vae32(x)[0]
            k3_fp32 = conv3d_stride1.LAUNCHES
            del vae32
            rec = torch.load(os.path.join(out_base, n, "clip0.pt"),
                             weights_only=True).to(dev)
            rel_l2 = ((rec - rec32).norm() / rec32.norm()).item()
            if not torch.isfinite(rec).all() or not torch.isfinite(
                    rec32).all() or rec.shape != rec32.shape or k3_fp32:
                raise AssertionError(f"{n}: fp16 {tuple(rec.shape)} vs fp32 "
                                     f"{tuple(rec32.shape)}, finite, K3 "
                                     f"launches in fp32 {k3_fp32}")
            if rel_l2 > 2e-2:
                raise AssertionError(f"{n}: fp16 K3 round trip against fp32 "
                                     f"F.conv3d: relative L2 {rel_l2} > 2e-2")
            m, r = by_name[n].metrics, runs[n]
            phase("harness_config", config=n, shape=json.dumps(
                list(rec.shape)), encode_tiles=te, decode_tiles=td,
                  k3_in_encode=sum(enc.values()),
                  k3_in_decode=sum(dec.values()),
                  **{f"{k}_in_encode_standalone": sum(
                      c * k3_ms[s][i] for s, c in enc.items())
                     for i, k in enumerate(("k3_ms", "f_conv3d_ms",
                                            "k3_bound_ms"))},
                  rel_l2_vs_fp32=rel_l2, psnr=m.mean_psnr, ssim=m.mean_ssim,
                  lpips=m.mean_lpips, encode_ms=json.dumps(r["encode_ms"]),
                  decode_ms=json.dumps(r["decode_ms"]),
                  round_trip_ms=json.dumps([a + b for a, b in zip(
                      r["encode_ms"], r["decode_ms"])]),
                  run_seconds=r["run_seconds"],
                  metrics_seconds=r["metrics_seconds"],
                  peak_gib=r["peak_gib"],
                  held_before_gib=r["held_before_gib"], card=smi)
            del rec, rec32

        cpu_lpips = lpips_from_state_dict(lpips_model.state_dict(), "cpu")
        for n in ("base", "pool_1"):
            cpu = compute_metrics_dir(
                tensors, os.path.join(out_base, n),
                lpips_params=cpu_lpips if n == "base" else None,
                device="cpu", out_txt=os.path.join(root, f"{n}_cpu.txt"))
            for p, q in zip(by_name[n].metrics.pairs, cpu.pairs):
                checks = [(p.psnr, q.psnr, 1e-9), (p.ssim, q.ssim, 1e-9)]
                if q.lpips is not None:
                    checks.append((p.lpips, q.lpips, 1e-4))
                if p.name != q.name or any(
                        not abs(a - c) <= tol * abs(c) for a, c, tol in checks):
                    raise AssertionError(f"{n} {p}: metrics on the card "
                                         f"differ from the CPU's {q}")
        phase("harness_path", tiled_seconds=tiled_s, tiled_tiles=json.dumps(
            [tiled_plan[2], tiled_plan[3]]),
              tiled_encode_ms=json.dumps(tiled_ms["Encoder"]),
              tiled_decode_ms=json.dumps(tiled_ms["Decoder"]),
              k3_shapes=len(k3_ms), metrics_cpu_check="psnr/ssim rel 1e-9 "
              "(base, pool_1), lpips rel 1e-4 (base)", card=smi)
    finally:
        shutil.rmtree(root)


def grad_reference_check(dev, model, tol=5e-2):
    """Flow-match loss gradients of the QK-norm 2+2-block DiT with the
    flash kernels (blocks checkpointed: K1, then B5f, B5q, B5kv) against the
    same weights under plain attention (attn_mode="sdpa", torch autograd),
    relative L2 per parameter."""
    cfg = model.cfg
    batch, grid = train_batch(dev, cfg, (16, 5, 32, 32), 50, txt_len=64,
                              txt_valid=20)
    x0, noise, t, pe, mask, pe2, cos_g, sin_g = batch
    d = cos_g.shape[-1]
    tokens = [dit_mod.patchify_raw(x, cfg.patch_size) for x in (x0, noise)]
    model.requires_grad_(True)
    grads, losses = {}, {}
    for mode, remat in (("flash", True), ("sdpa", False)):
        set_attn_mode(model, mode)
        for m in model.modules():
            if isinstance(getattr(m, "cfg", None), DiTConfig):
                m.cfg = dataclasses.replace(m.cfg, remat_blocks=remat)
        reset_counts()
        with torch.enable_grad():
            loss = flow_match_loss(model, *tokens, t, pe, mask, pe2,
                                   cos_g.reshape(-1, d), sin_g.reshape(-1, d),
                                   None)
            loss.backward()
        if mode == "flash":
            launches = read_counts()
        losses[mode] = loss.item()
        grads[mode] = {n: p.grad.float() for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
    model.requires_grad_(False)
    rel = {n: ((grads["flash"][n] - g).norm() / g.norm()).item()
           for n, g in grads["sdpa"].items() if g.norm().item() > 0}
    worst = max(rel, key=rel.get)
    phase("grad_reference", model="HYVideo-T/2 2+2 blocks",
          check="flash kernels (checkpointed) vs plain attention",
          tokens=f"{grid[0] * grid[1] * grid[2]}+64",
          params_compared=len(rel), max_rel_l2=rel[worst], worst=worst,
          tol=tol, loss_flash=losses["flash"], loss_plain=losses["sdpa"],
          launches=json.dumps({k: n for k, n in launches.items() if n}))
    expect("gradient reference", launches, dict(
        flash_static=4, flash_fwd_lse=4, flash_bwd_dq=4, flash_bwd_dkv=4))
    if len(rel) < 0.9 * len(grads["sdpa"]) or not rel[worst] <= tol:
        raise AssertionError(f"gradients with the flash kernels disagree "
                             f"with plain attention: {worst} rel L2 "
                             f"{rel[worst]} ({len(rel)} compared)")


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
    rows += check_flash_backward(dev, smi)
    rows += check_flash_int8(dev, smi, rows[0]["library_ms"])
    rows += check_w8a8(dev, smi) + check_conv(dev, smi)
    check_conv_decode(dev, smi)
    rows += check_conv_v2(dev, smi)
    sta_rows = check_sta(dev, smi)
    rows += sta_rows + check_sta_int8(dev, smi, sta_rows[0]["library_ms"])
    rows += check_sta_ring(dev, smi, sta_rows[0]["library_ms"])
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
    sampler, sta_launches, sta_video = sta_main_path(smi)
    launches["sta_direct"] = sta_launches["sta_direct"]
    launches["sta_ring"] = sta_ring_path(sampler, sta_video,
                                         smi)["sta_ring"]
    del sta_video
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
    launches["conv3d_stride1_v2"] = conv_probe_path(smi)["conv3d_stride1_v2"]
    torch.cuda.empty_cache()
    harness_path(dev, smi)
    gc.collect()
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
    del models, k2_model
    k1_model = dit_mod.build_dit(k1_model.cfg, dev, torch.bfloat16,
                                 torch.Generator(dev).manual_seed(5))
    randomize_modulation(k1_model, 6)
    grad_reference_check(dev, k1_model)
    del k1_model
    torch.cuda.empty_cache()
    train_launches = train_path(dev, smi)
    for name in ("flash_fwd_lse", "flash_bwd_dq", "flash_bwd_dkv"):
        launches[name] = train_launches[name]
    torch.cuda.empty_cache()
    train_adamw_path(dev, smi)
    torch.cuda.empty_cache()
    train_sta_path(dev, smi)
    torch.cuda.empty_cache()
    train_entry_path(smi)
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
