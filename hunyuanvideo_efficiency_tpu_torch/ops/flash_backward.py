"""Differentiable flash attention (kernels B5f, B5q, B5kv).

Counterpart of the JAX package's ops/flash_backward.py: the standard flash
backward with probabilities recomputed from the saved row log-sum-exp,

    P  = exp(S - lse)            S = Q.K^T * scale + key_bias
    dV = P^T.dO                  dP = dO.V^T
    dS = P * (dP - delta)        delta = rowsum(dO * O)   (plain torch, fp32)
    dQ = dS.K * scale            dK = dS^T.Q * scale

as three kernels:

* `flash_fwd_lse` (B5f) replaces `_fwd_kernel`: the running-max forward that
  also writes lse = m + log(max(l, 1e-37)); it is the `LSE` instantiation of
  the forward template in `csrc/flash_attention.cu`. The two backward
  kernels are `csrc/flash_backward.cu`.
* `flash_bwd_dq` (B5q) replaces `_bwd_dq_kernel`: one block per 64-query
  tile, summing over key chunks.
* `flash_bwd_dkv` (B5kv) replaces `_bwd_dkv_kernel`: the transposed form,
  one block per 64-key tile, summing over query chunks.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(`flash_fwd_lse_plain`, `flash_bwd_dq_plain`, `flash_bwd_dkv_plain`: fp32
scores, the same rounding points) on CPU tensors; any other device raises.
`LAUNCHES` on each wrapper counts kernel launches.

`flash_attention_vjp` is the entry point of `attention(mode="flash")`. As in
the JAX package, a call that needs no gradient runs the LSE-free dispatch
(`flash_attention`, K1/K2); under differentiation the forward is B5f and
the backward B5q + B5kv. With per-block checkpointing in its reentrant form
(models/dit.py) the first forward of a block runs without grad, so a train
step launches, per block, one K1 (or K2), then in the recomputation one B5f,
and in the backward one B5q and one B5kv.

Not carried over from the TPU version (tiling only, the same math): the
8-sublane [B, H*8, Sq] layout of lse and delta (here [B, H, Sq]), the
[B, 8, Sk] bias broadcast, padding S to block multiples (the kernels mask
ragged edges), and the block-size arguments, accepted for signature parity.

Bound on the H100: 4, 6 and 8 times B*H*Sq*Sk*D tensor-core operations for
B5f, B5q and B5kv, far above their bytes at the main path's lengths.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib
from .flash_attention import (_DTYPE_CODE, _as_rows, flash_attention,
                              split_plan)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _scores(q, k, key_bias, scale):
    """fp32 S = Q.K^T * scale + key_bias, [B, H, Sq, Sk]."""
    s = torch.matmul(q.float().transpose(1, 2),
                     k.float().permute(0, 2, 3, 1)) * scale
    if key_bias is not None:
        s = s + key_bias.float()[:, None, None, :]
    return s


def flash_fwd_lse_plain(q, k, v, key_bias, scale: float):
    """B5f in plain PyTorch. q/k/v [B, S, H, D]; key_bias [B, Sk] fp32 or
    None. Returns out [B, Sq, H*D] in q's dtype and lse [B, H, Sq] fp32."""
    b, sq, h, d = q.shape
    s = _scores(q, k, key_bias, scale)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_fin = p.sum(dim=-1).clamp_min(1e-37)
    pv = torch.matmul(p.to(v.dtype).float(), v.float().transpose(1, 2))
    out = (pv / l_fin[..., None]).to(q.dtype)
    return (out.transpose(1, 2).reshape(b, sq, h * d),
            m + torch.log(l_fin))


def _p_ds(q, k, v, key_bias, do, lse, delta, scale):
    """Recomputed fp32 P and dS = P * (dO.V^T - delta), [B, H, Sq, Sk]."""
    b, sq, h, d = q.shape
    p = torch.exp(_scores(q, k, key_bias, scale) - lse[..., None])
    dof = do.reshape(b, sq, h, d).float().transpose(1, 2)
    dp = torch.matmul(dof, v.float().permute(0, 2, 3, 1))
    return p, p * (dp - delta[..., None]), dof


def flash_bwd_dq_plain(q, k, v, key_bias, do, lse, delta, scale: float):
    """B5q in plain PyTorch: dQ [B, Sq, H, D] in q's dtype. do [B, Sq, H*D];
    lse, delta [B, H, Sq] fp32."""
    _, ds, _ = _p_ds(q, k, v, key_bias, do, lse, delta, scale)
    dq = torch.matmul(ds.to(k.dtype).float(), k.float().transpose(1, 2))
    return (dq * scale).to(q.dtype).transpose(1, 2)


def flash_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, scale: float):
    """B5kv in plain PyTorch: (dK, dV), each [B, Sk, H, D] in the input
    dtype."""
    p, ds, dof = _p_ds(q, k, v, key_bias, do, lse, delta, scale)
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float().transpose(1, 2))
    return ((dk * scale).to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def flash_bwd_plain(q, k, v, key_bias, do, lse, delta, scale: float):
    """Both backward kernels in plain PyTorch: (dQ, dK, dV)."""
    dk, dv = flash_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, scale)
    return (flash_bwd_dq_plain(q, k, v, key_bias, do, lse, delta, scale),
            dk, dv)


def row_delta(do, out, heads: int):
    """delta = rowsum(dO * O) per head in fp32: [B, Sq, H*D] x2 ->
    [B, H, Sq]."""
    b, sq, hd = do.shape
    prod = do.float().reshape(b, sq, heads, hd // heads) \
        * out.float().reshape(b, sq, heads, hd // heads)
    return prod.sum(dim=-1).transpose(1, 2).contiguous()


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _prepare(name, q, k, v, key_bias):
    """Validated kernel operands: q/k/v addressable by (batch, row) strides
    and the fp32 [B, Sk] key bias (or None)."""
    for what, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda:
            raise ValueError(f"{name}: {what} is on {x.device}, not a CUDA "
                             f"device")
        if x.dtype != q.dtype:
            raise TypeError(f"{name}: q, k, v must share a dtype")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes bf16 or fp16, got {q.dtype}")
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if d not in (64, 128):
        raise ValueError(f"{name} takes head_dim 64 or 128, got {d}")
    if k.shape != (b, sk, h, d) or v.shape != (b, sk, h, d):
        raise ValueError(f"{name}: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    kb = (key_bias.reshape(b, sk).to(torch.float32).contiguous()
          if key_bias is not None else None)
    return _as_rows(q), _as_rows(k), _as_rows(v), kb


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
            v.stride(1))


def _backward_operands(name, q, do, lse, delta):
    b, sq, h, d = q.shape
    if do.shape != (b, sq, h * d) or do.dtype != q.dtype or not do.is_cuda:
        raise ValueError(f"{name}: dO must be a CUDA {q.dtype} "
                         f"[{b}, {sq}, {h * d}] tensor, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    for what, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, sq) or x.dtype != torch.float32:
            raise ValueError(f"{name}: {what} must be fp32 [{b}, {h}, {sq}]")
    return do.contiguous(), lse.contiguous(), delta.contiguous()


def flash_fwd_lse(q, k, v, key_bias, scale: float):
    """B5f: running-max attention that also returns the row log-sum-exp.
    q/k/v [B, S, H, D]; key_bias [B, Sk] fp32 (entries <= 0) or None.
    Returns out [B, Sq, H*D] and lse [B, H, Sq] fp32. Kernel on CUDA tensors,
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v, key_bias, scale)
    q, k, v, kb = _prepare("flash_fwd_lse", q, k, v, key_bias)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h * d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    splits, part = split_plan(b, h, sq, k.shape[1], d, q.device)
    with torch.cuda.device(q.device):
        err = cuda_lib.library("flash_attention").hv_flash_fwd_lse(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            kb.data_ptr() if kb is not None else None, lse.data_ptr(), b, h,
            sq, k.shape[1], *_strides(q, k, v), float(scale), splits,
            part.data_ptr() if part is not None else None,
            cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "flash forward with LSE")
    flash_fwd_lse.LAUNCHES += 1
    return out, lse


flash_fwd_lse.LAUNCHES = 0


def flash_bwd_dq(q, k, v, key_bias, do, lse, delta, scale: float):
    """B5q: dQ [B, Sq, H, D] in q's dtype from dO [B, Sq, H*D], lse and
    delta [B, H, Sq] fp32. Kernel on CUDA tensors, plain version on CPU
    tensors. Runs on the calling thread's current stream (autograd's
    thread in a backward pass)."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, key_bias, do, lse, delta, scale)
    q, k, v, kb = _prepare("flash_bwd_dq", q, k, v, key_bias)
    do, lse, delta = _backward_operands("flash_bwd_dq", q, do, lse, delta)
    b, sq, h, d = q.shape
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = cuda_lib.library("flash_backward").hv_flash_bwd_dq(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(),
            kb.data_ptr() if kb is not None else None, lse.data_ptr(),
            delta.data_ptr(), dq.data_ptr(), b, h, sq, k.shape[1],
            *_strides(q, k, v), float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "flash backward dQ")
    flash_bwd_dq.LAUNCHES += 1
    return dq


flash_bwd_dq.LAUNCHES = 0


def flash_bwd_dkv(q, k, v, key_bias, do, lse, delta, scale: float):
    """B5kv: (dK, dV), each [B, Sk, H, D] in the input dtype; a key whose
    bias is -1e30 gets exactly zero rows. Kernel on CUDA tensors, plain
    version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, key_bias, do, lse, delta, scale)
    q, k, v, kb = _prepare("flash_bwd_dkv", q, k, v, key_bias)
    do, lse, delta = _backward_operands("flash_bwd_dkv", q, do, lse, delta)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    dk = torch.empty((b, sk, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        err = cuda_lib.library("flash_backward").hv_flash_bwd_dkv(
            _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), do.data_ptr(),
            kb.data_ptr() if kb is not None else None, lse.data_ptr(),
            delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, sq, sk,
            *_strides(q, k, v), float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "flash backward dK/dV")
    flash_bwd_dkv.LAUNCHES += 1
    return dk, dv


flash_bwd_dkv.LAUNCHES = 0


# --------------------------------------------------------------------------
# public differentiable API
# --------------------------------------------------------------------------

class FlashAttentionVJP(torch.autograd.Function):
    """B5f forward, B5q + B5kv backward; key_bias and scale get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_bias, scale):
        out, lse = flash_fwd_lse(q, k, v, key_bias, scale)
        ctx.save_for_backward(q, k, v, key_bias, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, key_bias, out, lse = ctx.saved_tensors
        g = g.contiguous()   # autograd may hand over an expanded view
        delta = row_delta(g, out, q.shape[2])
        dq = flash_bwd_dq(q, k, v, key_bias, g, lse, delta, ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, key_bias, g, lse, delta, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_vjp(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_bias: Optional[torch.Tensor] = None,
    score_bound: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    block_q: int = 1024,
    block_k: int = 2048,
    bound_mode: str = "auto",
) -> torch.Tensor:
    """Differentiable flash attention; q/k/v [B, S, H, D] -> [B, Sq, H*D]
    (the JAX signature).

    When no gradient is wanted (grad mode off, or no input requires one)
    this is `flash_attention`: the LSE-free kernels, chosen by bound_mode
    and score_bound. Under differentiation the forward is the running-max
    kernel with LSE whatever bound_mode says, with the same forward values
    up to rounding. key_bias ([B, 1, 1, Sk] or [B, Sk], entries <= 0) and
    score_bound get no gradient."""
    if not (torch.is_grad_enabled()
            and any(x.requires_grad for x in (q, k, v))):
        return flash_attention(q, k, v, key_bias, scale, block_q, block_k,
                               bound_mode, score_bound)
    b, _, _, d = q.shape
    kb = (key_bias.reshape(b, k.shape[1]).detach()
          if key_bias is not None else None)
    return FlashAttentionVJP.apply(
        q, k, v, kb, float(scale if scale is not None else d ** -0.5))
