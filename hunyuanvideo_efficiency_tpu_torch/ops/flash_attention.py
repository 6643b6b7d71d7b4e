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
kernel launches.

Bound on the H100: 4*B*H*Sq*Sk*D tensor-core operations (989 TFLOP/s
bf16), far above the bytes moved at the main path's lengths, so both are
bound by operations; see the source note in the .cu file for the design.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

NEG_INF = -1e30
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}


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
    lib = cuda_lib.library("flash_attention")
    err = lib.hv_flash_attention_fwd(
        _DTYPE_CODE[q.dtype], int(running), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(),
        kb.data_ptr() if kb is not None else None,
        cc.data_ptr() if cc is not None else None,
        m.data_ptr() if m is not None else None,
        l.data_ptr() if l is not None else None,
        b, h, sq, sk, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "flash attention")
    return (out, m, l) if return_state else out


def flash_static(q, k, v, key_bias, c, scale: float,
                 return_state: bool = False):
    """K1: static-offset softmax attention. q/k/v [B, S, H, D], key_bias
    [B, Sk] fp32 (entries <= 0) or None, c [B, H] fp32 bounding |s|*scale.
    Kernel on CUDA tensors, plain version on CPU tensors."""
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
    the CUDA kernel's tiles are fixed at 64 x 64.
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
