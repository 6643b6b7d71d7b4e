"""Flash attention over the MM-DiT joint [img | txt] sequence (kernels K1, K2).

Counterpart of the JAX package's ops/flash_attention.py. Two kernels with
one CUDA source (`csrc/flash_attention.cu`, template flag RUNNING):

* `flash_static` (K1) replaces `_flash_nomax_kernel`: the softmax with a
  static per-(batch, head) exponent offset C >= max|score| instead of a
  running max, p = exp(s*scale + (kb - C)). Models with QK-RMSNorm bound
  their scores by `models.dit._analytic_score_bound`, so this is the main
  path's kernel (60 launches per denoise step).
* `flash_running` (K2) replaces `_flash_kernel`: the classic online
  softmax, for inputs without such a bound.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(`flash_attention_plain`, fp32 scores, the same offset and rounding points)
on CPU tensors; any other device raises. `LAUNCHES` on each wrapper counts
kernel launches; under a profiler each call is a span named after it
(utils/profiling.py:span).

Bound on the H100: 4*B*H*Sq*Sk*D tensor-core operations (989 TFLOP/s
bf16), far above the bytes moved at the main path's lengths, so both are
bound by operations; see the source note in the .cu file for the design
(wgmma fed by a TMA ring, 128 query rows a block). When the query tiles
give too few blocks for the card (the STA text merge: 256 queries over
tens of thousands of keys), `flash_splits` splits each tile's keys over
several blocks and a second kernel of the same source merges the parts;
the wrapper still counts one launch.

`flash_attention_state` (JAX :535) is K1 with state made differentiable
for the ring hops of sequence-parallel training: the forward is K1, the
backward the autograd of a plain, chunked replica of K1's state
(`state_reference`, JAX `_state_reference` :473), as JAX's custom VJP
transposes a plain reference; no kernel computes that backward.

int8 Q.K^T (`flash_attention_int8`, JAX :816-906; `csrc/flash_int8.cu`):

* `flash_int8_static` (B8a) replaces `_flash_int8_nomax_kernel`, the
  static offset with the bound inflated for int8 rounding; the main path's
  kernel under `--attn-mode flash_int8` with QK-norm.
* `flash_int8_running` (B8b) replaces `_flash_int8_kernel`, the running
  max, for models without QK-norm.

Both quantize q and k symmetrically per (batch, head, block): one scale per
`q_group` query rows and per `k_group` key rows, the blocks the JAX
wrapper picks (`pick_block`, `int8_key_group`). A pre-pass kernel
(`quantize_groups`, plain version `quantize_groups_plain`) writes the int8
codes and scales; the attention kernel reads the codes by TMA into s8
wgmma products (the design note is in the .cu file). Their plain version
is `flash_int8_plain`, on the plain pre-pass.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..utils.profiling import span
from . import cuda_lib

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}
BLOCK_Q, BLOCK_K = 128, 128   # the kernel's query rows a block, keys a tile
MIN_SPLIT_TILES = 8           # key tiles a split walks at least


def flash_splits(b: int, h: int, sq: int, sk: int, sms: int) -> int:
    """Blocks each query tile's key range is split over, from the shapes
    and the card's SM count alone: 1 when the query tiles already give two
    blocks an SM, else the split from [n, 2n] (n the least that reaches two
    blocks an SM) whose last wave is fullest, each split walking at least
    MIN_SPLIT_TILES key tiles."""
    blocks = -(-sq // BLOCK_Q) * h * b
    most = -(-sk // BLOCK_K) // MIN_SPLIT_TILES
    if blocks >= 2 * sms or most < 2:
        return 1
    least = -(-2 * sms // blocks)
    cands = range(min(least, most), min(2 * least, most) + 1)
    return max(cands, key=lambda n: (n * blocks / (-(-n * blocks // sms)
                                                  * sms), -n))


def split_plan(b: int, h: int, sq: int, sk: int, d: int, device):
    """(splits, fp32 scratch of the parts' acc, m and l or None) for a
    launch on the CUDA `device`."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits = flash_splits(b, h, sq, sk, sms)
    part = (None if splits == 1 else
            torch.empty(splits * b * h * sq * (d + 2), dtype=torch.float32,
                        device=device))
    return splits, part


def flash_attention_plain(q, k, v, key_bias, c, scale: float, running: bool,
                          return_state: bool = False):
    """Exact-softmax reference of both kernels. q/k/v [B, S, H, D];
    key_bias [B, Sk] fp32 or None; c [B, H] fp32 (static offset; unused
    when running). Returns out [B, Sq, H*D] (and (m, l) [B, Sq, H] fp32)."""
    b, sq, h, d = q.shape
    qf = q.float().transpose(1, 2)                     # [B, H, Sq, D]
    kf = k.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # [B, H, Sq, Sk]
    kb = (key_bias.float()[:, None, None, :] if key_bias is not None
          else torch.zeros((), device=q.device))
    if running:
        x = s + kb
        m = x.amax(dim=-1)
        p = torch.exp(x - m[..., None])
    else:
        cc = c.float()[:, :, None, None]
        p = torch.exp(s + (kb - cc))
        m = cc[..., 0].expand(b, h, sq)
    l = p.sum(dim=-1)
    pv = torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))
    out = pv / l.clamp_min(1e-37)[..., None]
    out = out.to(q.dtype).transpose(1, 2).reshape(b, sq, h * d)
    if return_state:
        return out, m.transpose(1, 2).contiguous(), l.transpose(1, 2).contiguous()
    return out


def _as_rows(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] with unit element stride and heads packed per row, the
    layout the kernel addresses through (batch, row) strides."""
    d = x.shape[-1]
    if x.stride(-1) != 1 or x.stride(-2) != d or x.stride(1) % 8 \
            or x.stride(0) % 8 or x.data_ptr() % 16:
        x = x.contiguous()
    return x


def _launch(q, k, v, key_bias, c, scale, running, return_state):
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"flash kernel: {name} is on {x.device}, not "
                             f"a CUDA device")
        if x.dtype != q.dtype:
            raise TypeError("flash kernel: q, k, v must share a dtype")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernel takes bf16 or fp16, got {q.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"flash kernel takes head_dim 64 or 128, got {d}")
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d):
        raise ValueError(f"flash kernel: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    q, k, v = _as_rows(q), _as_rows(k), _as_rows(v)
    kb = (key_bias.reshape(b, sk).to(torch.float32).contiguous()
          if key_bias is not None else None)
    cc = None if running else c.to(torch.float32).expand(b, h).contiguous()
    out = torch.empty((b, sq, h * d), dtype=q.dtype, device=q.device)
    m = l = None
    if return_state:
        m = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    splits, part = split_plan(b, h, sq, sk, d, q.device)
    lib = cuda_lib.library("flash_attention")
    err = lib.hv_flash_attention_fwd(
        _DTYPE_CODE[q.dtype], int(running), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(),
        kb.data_ptr() if kb is not None else None,
        cc.data_ptr() if cc is not None else None,
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None,
        b, h, sq, sk, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), splits,
        part.data_ptr() if part is not None else None,
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "flash attention")
    return (out, m, l) if return_state else out


def flash_static(q, k, v, key_bias, c, scale: float,
                 return_state: bool = False):
    """K1: static-offset softmax attention. q/k/v [B, S, H, D], key_bias
    [B, Sk] fp32 (entries <= 0) or None, c [B, H] fp32 bounding |s|*scale.
    Kernel on CUDA tensors, plain version on CPU tensors."""
    with span("flash_static"):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, key_bias, c, scale, False,
                                         return_state)
        out = _launch(q, k, v, key_bias, c, scale, False, return_state)
    flash_static.LAUNCHES += 1
    return out


flash_static.LAUNCHES = 0


def flash_running(q, k, v, key_bias, scale: float,
                  return_state: bool = False):
    """K2: running-max online-softmax attention, same layout as K1.
    Kernel on CUDA tensors, plain version on CPU tensors."""
    with span("flash_running"):
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, key_bias, None, scale, True,
                                         return_state)
        out = _launch(q, k, v, key_bias, None, scale, True, return_state)
    flash_running.LAUNCHES += 1
    return out


flash_running.LAUNCHES = 0


def score_bound_from_norms(q, k, scale: float) -> torch.Tensor:
    """Cauchy-Schwarz bound C[b, h] = max_row|q| * max_row|k| * scale."""
    qn = q.float().square().sum(-1).sqrt().amax(dim=1)
    kn = k.float().square().sum(-1).sqrt().amax(dim=1)
    return qn * kn * scale


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = 1024,
    block_k: int = 2048,
    bound_mode: str = "auto",
    score_bound: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Flash attention; q/k/v [B, S, H, D] -> [B, Sq, H*D] (JAX signature).

    key_bias: [B, 1, 1, Sk] (or [B, Sk]) additive bias, entries <= 0.
    score_bound: bound on |q.k|*scale broadcastable to [B, H]; without one
    the Cauchy-Schwarz bound of the row norms is used.
    bound_mode: "static" -> K1, "running" -> K2, "auto" -> K1 when
    max(C) < 40 (well inside the fp32 exp range), else K2; "auto" reads C
    on the host.
    return_state: also return (m, l), each [B, Sq, H] fp32 (m = C for K1),
    the partial-softmax state that `merge_flash_states` folds.
    block_q, block_k: accepted for signature parity with the JAX function;
    the CUDA kernel's tiles are fixed at BLOCK_Q x BLOCK_K.
    """
    del block_q, block_k
    if bound_mode not in ("static", "running", "auto"):
        raise ValueError(f"bound_mode must be static|running|auto, got "
                         f"{bound_mode!r}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    kb = key_bias.reshape(b, sk) if key_bias is not None else None
    if bound_mode == "running":
        return flash_running(q, k, v, kb, scale, return_state)
    if score_bound is not None:
        c = torch.as_tensor(score_bound, dtype=torch.float32,
                            device=q.device).expand(b, h)
    else:
        c = score_bound_from_norms(q, k, scale)
    if bound_mode == "auto" and float(c.max()) >= 40.0:
        return flash_running(q, k, v, kb, scale, return_state)
    return flash_static(q, k, v, kb, c, scale, return_state)


def merge_flash_states(s1, s2):
    """Merge two partial-softmax states (out, m, l) over disjoint key sets.
    out [B, Sq, H*D] (or [B, Sq, H, D]), m/l [B, Sq, H] fp32; each out is
    normalized by its own l (what `return_state` yields)."""
    o1, m1, l1 = s1
    o2, m2, l2 = s2
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m) * l1
    a2 = torch.exp(m2 - m) * l2
    l = a1 + a2
    w1 = a1 / l.clamp_min(1e-37)
    w2 = a2 / l.clamp_min(1e-37)
    if o1.ndim == 3:
        b, sq, hd = o1.shape
        hh = m1.shape[-1]
        o = (o1.reshape(b, sq, hh, hd // hh).float() * w1[..., None]
             + o2.reshape(b, sq, hh, hd // hh).float() * w2[..., None])
        return o.reshape(b, sq, hd).to(o1.dtype), m, l
    o = o1.float() * w1[..., None] + o2.float() * w2[..., None]
    return o.to(o1.dtype), m, l


# --------------------------------------------------------------------------
# differentiable state-returning flash (ring sequence-parallel training)
# --------------------------------------------------------------------------

def _state_fold(acc, l, qf, k, v, kb, c):
    """One key chunk of `state_reference`: acc += p.v, l += rowsum p."""
    s = torch.matmul(qf, k.float().permute(0, 2, 3, 1))
    p = torch.exp(s + (kb[:, None, None, :] - c[:, :, None, None]))
    return (acc + torch.matmul(p, v.float().transpose(1, 2)),
            l + p.sum(dim=-1))


def state_reference(q, k, v, key_bias, c, scale: float, k_chunk: int = 2048):
    """Plain, differentiable replica of K1's partial-softmax state (JAX
    `_state_reference`): p = exp(s*scale + key_bias - C), l = rowsum p,
    out = p.v / max(l, 1e-37), m = C. q/k/v [B, S, H, D]; key_bias [B, Sk]
    (or [B, 1, 1, Sk]) or None; c [B, H]. Keys fold `k_chunk` at a time,
    each chunk under torch.utils.checkpoint, so neither pass holds more
    than one [B, H, Sq, k_chunk] fp32 score block. Returns (out [B, Sq,
    H*D] in q's dtype, m, l [B, Sq, H] fp32)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qf = q.float().transpose(1, 2) * scale
    kb = (key_bias.reshape(b, sk).float() if key_bias is not None
          else torch.zeros((b, sk), device=q.device))
    c = c.float()
    acc = torch.zeros((b, h, sq, d), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    for k0 in range(0, sk, k_chunk):
        ks = slice(k0, k0 + k_chunk)
        acc, l = checkpoint(_state_fold, acc, l, qf, k[:, ks], v[:, ks],
                            kb[:, ks], c, use_reentrant=False)
    out = acc / l.clamp_min(1e-37)[..., None]
    out = out.transpose(1, 2).reshape(b, sq, h * d).to(q.dtype)
    return out, c[:, None, :].expand(b, sq, h), l.transpose(1, 2)


class _FlashState(torch.autograd.Function):
    """K1 with state forward, the autograd of `state_reference` backward
    (JAX `_flash_state_diff`'s custom VJP). c takes no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, c, scale, k_chunk):
        ctx.save_for_backward(q, k, v, key_bias, c)
        ctx.scale, ctx.k_chunk = scale, k_chunk
        b, sk = k.shape[:2]
        kb = key_bias.reshape(b, sk) if key_bias is not None else None
        out, m, l = flash_static(q, k, v, kb, c, scale, return_state=True)
        ctx.mark_non_differentiable(m)
        return out, m, l

    @staticmethod
    def backward(ctx, g_out, g_m, g_l):
        q, k, v, key_bias, c = ctx.saved_tensors
        want = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(w) if x is not None else None
                   for x, w in zip((q, k, v, key_bias), want)]
            out, _, l = state_reference(*ins, c, ctx.scale, ctx.k_chunk)
            wrt = [x for x, w in zip(ins, want) if w]
            got = iter(torch.autograd.grad((out, l), wrt, (g_out, g_l)))
        return (*(next(got) if w else None for w in want), None, None, None)


def flash_attention_state(q, k, v, key_bias=None, scale=None,
                          score_bound=None, k_chunk: int = 2048):
    """Differentiable `flash_attention(..., bound_mode="static",
    return_state=True)` (JAX `flash_attention_state`): K1 runs the forward
    (its plain version on CPU tensors), the backward transposes the chunked
    plain replica `state_reference`. Returns (out [B, Sq, H*D], m, l
    [B, Sq, H] fp32) for `merge_flash_states`.

    The offset C (score_bound, broadcast to [B, H], or the Cauchy-Schwarz
    bound of the row norms) is detached, as JAX's stop_gradient: the merged
    softmax is exactly invariant to it. Static-offset regime only (QK-norm);
    running-max rings differentiate through the plain recurrence."""
    b, _, h, d = q.shape
    scale = float(scale if scale is not None else d ** -0.5)
    if score_bound is None:
        c = score_bound_from_norms(q, k, scale)
    else:
        c = torch.as_tensor(score_bound, dtype=torch.float32,
                            device=q.device).expand(b, h)
    return _FlashState.apply(q, k, v, key_bias, c.detach().contiguous(),
                             scale, k_chunk)


# --------------------------------------------------------------------------
# int8 Q.K^T (SageAttention-style, arXiv 2410.02367)
# --------------------------------------------------------------------------

def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_block(block: int, s: int) -> int:
    """Largest block <= `block` that divides s, if any (JAX
    ops/flash_attention.py:_pick_block): the int8 kernels' quantization
    groups follow the JAX wrapper's blocks."""
    block = min(block, _round_up(s, 128))
    if s % block == 0:
        return block
    for cand in (1024, 512, 256, 128):
        if cand < block and s % cand == 0:
            return cand
    return block


def int8_key_group(block_k: int, static: bool) -> int:
    """Keys per int8 quantization group: block_k split into the JAX
    kernels' sub-blocks (4/2/1 static, 2/1 running)."""
    if static:
        n_sub = 4 if block_k % 512 == 0 else (2 if block_k % 256 == 0 else 1)
    else:
        n_sub = 2 if block_k % 256 == 0 else 1
    return block_k // n_sub


def int8_bound_inflation(d: int) -> float:
    """(1 + sqrt(d)/254)^2: a static bound on |q.k|*scale also bounds the
    int8-rounded scores after this factor (rounding adds at most sqrt(d)/2
    steps to a row norm of at least 127 steps)."""
    return (1.0 + d ** 0.5 / 254.0) ** 2


def quantize_groups_plain(x: torch.Tensor, group: int):
    """Symmetric int8 codes of x [B, S, H, D] per (batch, head, group of
    `group` rows), the last group padded with zero rows: codes int8 [B, S,
    H*D] and scales fp32 [B, H, ceil(S/group)], scale = max(max|x|, 1e-6) *
    (1/127), codes round(x * (1/scale)) with ties to even (the TPU
    kernels' rounding; the clamp to +-127 only guards it)."""
    b, s, h, d = x.shape
    n = -(-s // group)
    xf = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, n * group - s))
    xf = xf.reshape(b, n, group, h, d)
    sc = xf.abs().amax(dim=(2, 4)).clamp_min(1e-6) * (1.0 / 127.0)
    codes = torch.round(xf * (1.0 / sc)[:, :, None, :, None])
    codes = codes.clamp_(-127, 127).reshape(b, n * group, h * d)[:, :s]
    return codes.to(torch.int8), sc.transpose(1, 2).contiguous()


def _check_int8_launch(q, k, v, q_group, k_group):
    """What the int8 kernels take, checked before anything is launched."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"flash int8 kernel takes head_dim 64 or 128, got "
                         f"{d}")
    if k.shape != (b, sk, h, d) or (v is not None and v.shape != k.shape):
        raise ValueError(f"flash int8 kernel: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} "
                         f"v {None if v is None else tuple(v.shape)}")
    if q_group % 64 or k_group % 64 or q_group <= 0 or k_group <= 0:
        raise ValueError(f"flash int8 kernel: groups {q_group}/{k_group} "
                         f"are not multiples of 64")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x is None:
            continue
        if not x.is_cuda:
            raise ValueError(f"flash int8 kernel: {name} is on {x.device}, "
                             f"not a CUDA device")
        if x.dtype != q.dtype:
            raise TypeError("flash int8 kernel: q, k, v must share a dtype")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"flash int8 kernel takes bf16 or fp16, got "
                        f"{q.dtype}")


def _quantize_launch(q, k, q_group, k_group):
    """The pre-pass kernel: ((q8, sq), (k8, sk)) and the key scales once
    per 64 keys [B, H, ceil(Sk/64)], which the attention kernel reads."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    q, k = _as_rows(q), _as_rows(k)
    q8 = torch.empty((b, sq, h * d), dtype=torch.int8, device=q.device)
    k8 = torch.empty((b, sk, h * d), dtype=torch.int8, device=q.device)
    sq_s, sk_s, sk64 = (
        torch.empty((b, h, -(-n // g)), dtype=torch.float32, device=q.device)
        for n, g in ((sq, q_group), (sk, k_group), (sk, 64)))
    err = cuda_lib.library("flash_int8").hv_quantize_groups(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), q.stride(0), q.stride(1), sq,
        q_group, k.data_ptr(), k.stride(0), k.stride(1), sk, k_group, b, h,
        q8.data_ptr(), k8.data_ptr(), sq_s.data_ptr(), sk_s.data_ptr(),
        sk64.data_ptr(), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "int8 quantization pre-pass")
    return (q8, sq_s), (k8, sk_s), sk64


def quantize_groups(q, k, q_group: int, k_group: int):
    """The int8 kernels' pre-pass: ((q8, sq), (k8, sk)) as
    `quantize_groups_plain` gives them for q and k. One kernel launch for
    both on CUDA tensors (csrc/flash_int8.cu; B8a/B8b launch it themselves,
    this entry is for checking and timing it alone), the plain version on
    CPU tensors."""
    if q.device.type == "cpu":
        return (quantize_groups_plain(q, q_group),
                quantize_groups_plain(k, k_group))
    _check_int8_launch(q, k, None, q_group, k_group)
    return _quantize_launch(q, k, q_group, k_group)[:2]


def flash_int8_plain(q, k, v, key_bias, c, scale: float, running: bool,
                     q_group: int, k_group: int, return_state: bool = False):
    """Both int8 kernels in plain PyTorch, on `quantize_groups_plain`'s
    codes and scales. q/k/v [B, S, H, D]; key_bias [B, Sk] fp32 or None; c
    [B, H] fp32 static offset (unused when running). s = s32(q8.k8^T) *
    (sq*sk*scale) (the codes' product is exact in fp32 for D <= 1040), then
    the static p = exp(s + (kb - c)) or the exact softmax, p rounded to v's
    type before P.V. One head at a time. Returns [B, Sq, H*D] (and (m, l)
    [B, Sq, H] fp32, m = c when static, as `flash_attention_plain`)."""
    b, sq_len, h, d = q.shape
    sk_len = k.shape[1]
    q8, sq = quantize_groups_plain(q, q_group)
    k8, sk = quantize_groups_plain(k, k_group)
    q8 = q8.reshape(b, sq_len, h, d).float()
    k8 = k8.reshape(b, sk_len, h, d).float()
    sq = sq.repeat_interleave(q_group, 2)[..., :sq_len]     # [B, H, Sq]
    sk = sk.repeat_interleave(k_group, 2)[..., :sk_len]     # [B, H, Sk]
    kb = (key_bias.reshape(b, sk_len).float() if key_bias is not None
          else torch.zeros((b, sk_len), device=q.device))[:, None, :]
    out = torch.empty((b, sq_len, h, d), dtype=q.dtype, device=q.device)
    m_st = torch.empty((b, sq_len, h), dtype=torch.float32, device=q.device)
    l_st = torch.empty_like(m_st)
    for hi in range(h):
        s32 = torch.matmul(q8[:, :, hi], k8[:, :, hi].transpose(-1, -2))
        s = s32 * ((sq[:, hi, :, None] * sk[:, hi, None, :]) * scale)
        if running:
            x = s + kb
            m = x.amax(dim=-1, keepdim=True)
            p = torch.exp(x - m)
        else:
            m = c.float()[:, hi, None, None].expand(b, sq_len, 1)
            p = torch.exp(s + (kb - m))
        pv = torch.matmul(p.to(v.dtype).float(), v[:, :, hi].float())
        l = p.sum(dim=-1)
        out[:, :, hi] = (pv / l.clamp_min(1e-37)[..., None]).to(q.dtype)
        m_st[:, :, hi], l_st[:, :, hi] = m[..., 0], l
    out = out.reshape(b, sq_len, h * d)
    return (out, m_st, l_st) if return_state else out


def _launch_int8(q, k, v, key_bias, c, scale, running, q_group, k_group,
                 return_state=False):
    _check_int8_launch(q, k, v, q_group, k_group)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    (q8, sq_s), (k8, _), sk64 = _quantize_launch(q, k, q_group, k_group)
    v = _as_rows(v)
    kb = (key_bias.reshape(b, sk).to(torch.float32).contiguous()
          if key_bias is not None else None)
    cc = None if running else c.to(torch.float32).expand(b, h).contiguous()
    out = torch.empty((b, sq, h * d), dtype=q.dtype, device=q.device)
    m = l = None
    if return_state:
        m = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    err = cuda_lib.library("flash_int8").hv_flash_int8_fwd(
        _DTYPE_CODE[q.dtype], int(running), d, q8.data_ptr(), k8.data_ptr(),
        v.data_ptr(), out.data_ptr(),
        kb.data_ptr() if kb is not None else None,
        cc.data_ptr() if cc is not None else None, sq_s.data_ptr(),
        sk64.data_ptr(), m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None, b, h, sq, sk, q_group,
        v.stride(0), v.stride(1), float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "flash int8 attention")
    return (out, m, l) if return_state else out


def flash_int8_static(q, k, v, key_bias, c, scale: float, q_group: int,
                      k_group: int, return_state: bool = False):
    """B8a: int8 Q.K^T with the static offset c [B, H] (already inflated
    for int8 rounding). q/k/v [B, S, H, D] -> [B, Sq, H*D] (and the state
    (m, l) with return_state). Kernel on CUDA tensors, plain version on
    CPU tensors."""
    with span("flash_int8_static"):
        if q.device.type == "cpu":
            return flash_int8_plain(q, k, v, key_bias, c, scale, False,
                                    q_group, k_group, return_state)
        out = _launch_int8(q, k, v, key_bias, c, scale, False, q_group,
                           k_group, return_state)
    flash_int8_static.LAUNCHES += 1
    return out


flash_int8_static.LAUNCHES = 0


def flash_int8_running(q, k, v, key_bias, scale: float, q_group: int,
                       k_group: int, return_state: bool = False):
    """B8b: int8 Q.K^T with the running-max online softmax. Kernel on CUDA
    tensors, plain version on CPU tensors."""
    with span("flash_int8_running"):
        if q.device.type == "cpu":
            return flash_int8_plain(q, k, v, key_bias, None, scale, True,
                                    q_group, k_group, return_state)
        out = _launch_int8(q, k, v, key_bias, None, scale, True, q_group,
                           k_group, return_state)
    flash_int8_running.LAUNCHES += 1
    return out


flash_int8_running.LAUNCHES = 0


def flash_attention_int8(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = 1024,
    block_k: int = 2048,
    smooth_k: bool = True,
    bound_mode: str = "running",
    score_bound: Optional[torch.Tensor] = None,
    plain: bool = False,
    key_mean: Optional[torch.Tensor] = None,
    return_state: bool = False,
):
    """Flash attention with int8 Q.K^T; q/k/v [B, S, H, D] -> [B, Sq, H*D]
    (the JAX signature and semantics).

    smooth_k subtracts the per-(batch, head, channel) key mean over the whole
    key axis (masked text padding included), taken in fp32 and cast back:
    softmax cancels the per-query constant it changes, and the int8 error
    shrinks. key_mean [B, 1, H, D] fp32 replaces this call's own mean: calls
    over disjoint key sets whose states are merged (the ring's hops) must
    subtract one mean, that of all their keys, for the per-query constant
    to cancel across them. return_state also returns (m, l) [B, Sq, H]
    fp32 of the smoothed scores, as `flash_attention` does. bound_mode "static" -> B8a with the bound inflated by
    `int8_bound_inflation` (score_bound, or the Cauchy-Schwarz bound of the
    smoothed q/k); anything else -> B8b. Unlike `flash_attention`, there is
    no fallback to the running kernel for a large bound. block_q/block_k
    pick the quantization groups as in the JAX wrapper. plain=True runs
    the plain version on any device (a reference for checks on the card).
    """
    b, sq_len, hh, d = q.shape
    sk_len = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    static = bound_mode == "static"
    q_group = pick_block(block_q, sq_len)
    k_group = int8_key_group(pick_block(block_k, sk_len), static)
    if smooth_k:
        mean = (key_mean if key_mean is not None
                else k.float().mean(dim=1, keepdim=True))
        k = k - mean.to(k.dtype)
    kb = key_bias.reshape(b, sk_len) if key_bias is not None else None
    if not static:
        if plain:
            return flash_int8_plain(q, k, v, kb, None, scale, True, q_group,
                                    k_group, return_state)
        return flash_int8_running(q, k, v, kb, scale, q_group, k_group,
                                  return_state)
    if score_bound is not None:
        c = torch.as_tensor(score_bound, dtype=torch.float32,
                            device=q.device).expand(b, hh)
    else:
        c = score_bound_from_norms(q, k, scale)
    c = c * int8_bound_inflation(d)
    if plain:
        return flash_int8_plain(q, k, v, kb, c, scale, False, q_group,
                                k_group, return_state)
    return flash_int8_static(q, k, v, kb, c, scale, q_group, k_group,
                             return_state)
