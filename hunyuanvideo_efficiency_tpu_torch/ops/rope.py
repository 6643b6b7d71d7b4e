"""3-axis rotary position embedding for video tokens (JAX counterpart:
ops/rope.py; reference: hyvideo/modules/posemb_layers.py:191-310).

Per-axis 1-D frequencies concatenated along head_dim (rope_dim_list
(16, 56, 56) over (t, h, w)), real (cos, sin) tables interleave-duplicated
and applied as x*cos + rotate_half(x)*sin with pairs (x0, x1) -> (-x1, x0).
Tables are built in numpy in fp32; the rotation runs in fp32 and casts back.

`qk_norm_rope` is the DiT's QK-RMSNorm + RoPE of a q/k pair in one launch
of a hand-written kernel (`csrc/qk_rope.cu`, no Pallas counterpart: XLA
fused the JAX ops) on CUDA tensors, its plain version `qk_norm_rope_plain`
(`rms_norm` then `rotate_tokens`, the same rounding points) on CPU tensors
or under plain=True. Tokens past the table's rows are only normalized.
`LAUNCHES` on it counts kernel launches. Under grad the kernel runs the
forward and the backward is the autograd of the plain version, recomputed.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import cuda_lib
from .norms import rms_norm

QK_ROPE_DTYPES = (torch.bfloat16, torch.float16)
QK_ROPE_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}


def get_1d_rotary_pos_embed(dim: int, pos: np.ndarray, theta: float = 10000.0,
                            theta_rescale_factor: float = 1.0,
                            interpolation_factor: float = 1.0
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin), each [S, dim], interleave-duplicated."""
    pos = np.asarray(pos, dtype=np.float32)
    if theta_rescale_factor != 1.0:
        theta = theta * theta_rescale_factor ** (dim / (dim - 2))
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2]
                             / dim))
    angles = np.outer(pos * interpolation_factor, freqs)
    return (np.repeat(np.cos(angles), 2, axis=1),
            np.repeat(np.sin(angles), 2, axis=1))


def get_meshgrid_nd(sizes: Sequence[int]) -> List[np.ndarray]:
    """Flattened per-axis coordinates of an n-d grid in row-major order."""
    axes = [np.arange(s, dtype=np.float32) for s in sizes]
    return [g.reshape(-1) for g in np.meshgrid(*axes, indexing="ij")]


def get_nd_rotary_pos_embed(
    rope_dim_list: Sequence[int],
    sizes: Sequence[int],
    theta: float = 10000.0,
    theta_rescale_factor: Union[float, Sequence[float]] = 1.0,
    interpolation_factor: Union[float, Sequence[float]] = 1.0,
    device="cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) fp32 tables [prod(sizes), sum(rope_dim_list)] on device."""
    n = len(rope_dim_list)
    if len(sizes) != n:
        raise ValueError(f"{len(sizes)} sizes for {n} rope axes")
    if isinstance(theta_rescale_factor, (int, float)):
        theta_rescale_factor = [float(theta_rescale_factor)] * n
    if isinstance(interpolation_factor, (int, float)):
        interpolation_factor = [float(interpolation_factor)] * n
    coords = get_meshgrid_nd(sizes)
    parts = [get_1d_rotary_pos_embed(rope_dim_list[i], coords[i], theta,
                                     theta_rescale_factor[i],
                                     interpolation_factor[i])
             for i in range(n)]
    cos = np.concatenate([p[0] for p in parts], axis=1)
    sin = np.concatenate([p[1] for p in parts], axis=1)
    return (torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device))


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    x2 = x.unflatten(-1, (-1, 2))
    return torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).flatten(-2)


def rotate_tokens(x: torch.Tensor, freqs_cis: Tuple[torch.Tensor, torch.Tensor],
                  pre=None) -> torch.Tensor:
    """Rotate [B, S, H, D] with (cos, sin) tables [S, D]; `pre` is an
    optional per-token map (the QK norm) applied first, in the same pass."""
    cos, sin = freqs_cis
    if pre is not None:
        x = pre(x)
    xf = x.float()
    out = (xf * cos[None, :, None, :]
           + _rotate_half_interleaved(xf) * sin[None, :, None, :])
    return out.to(x.dtype)


def apply_rotary_emb(xq: torch.Tensor, xk: torch.Tensor,
                     freqs_cis: Tuple[torch.Tensor, torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k, each [B, S, H, D]."""
    return rotate_tokens(xq, freqs_cis), rotate_tokens(xk, freqs_cis)


Freqs = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _norm_rope_plain(x: torch.Tensor, weight: Optional[torch.Tensor],
                     freqs: Freqs, eps: float) -> torch.Tensor:
    """rms_norm then rotate_tokens over the tokens the table covers; the
    tokens past its rows only normalized."""
    s = x.shape[1]
    n = 0 if freqs is None else min(freqs[0].shape[0], s)

    def pre(t):
        return rms_norm(t, weight, eps)

    if n == 0:
        return pre(x)
    table = (freqs[0][:n], freqs[1][:n])
    if n == s:
        return rotate_tokens(x, table, pre=pre)
    return torch.cat([rotate_tokens(x[:, :n], table, pre=pre),
                      pre(x[:, n:])], dim=1)


def qk_norm_rope_plain(q: torch.Tensor, k: torch.Tensor,
                       q_weight: Optional[torch.Tensor],
                       k_weight: Optional[torch.Tensor], freqs: Freqs,
                       eps: float = 1e-6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `qk_norm_rope`: `rms_norm` then
    `rotate_tokens` on each of q and k, the DiT's composition."""
    return (_norm_rope_plain(q, q_weight, freqs, eps),
            _norm_rope_plain(k, k_weight, freqs, eps))


def _refusal(x: torch.Tensor, weight: Optional[torch.Tensor] = None
             ) -> Optional[str]:
    """Why the kernel cannot take x [..., D] normalized by `weight`, or
    None: it takes bf16 and fp16, head_dim 64 and 128, a weight of x's
    type (another type makes the plain product another type)."""
    if x.dtype not in QK_ROPE_DTYPES:
        return f"dtype {x.dtype}"
    if x.shape[-1] not in QK_ROPE_HEAD_DIMS:
        return f"head_dim {x.shape[-1]}"
    if weight is not None and weight.dtype != x.dtype:
        return f"weight dtype {weight.dtype} for {x.dtype} values"
    return None


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """x as the kernel reads it: unit stride over the last axis, the other
    strides multiples of 8 values, 16-byte aligned (a copy only where
    not)."""
    if x.stride(-1) != 1 or any(st % 8 for st in x.stride()[:-1]):
        x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _launch(q, k, q_weight, k_weight, freqs: Freqs, eps: float):
    b, s, h, d = q.shape
    if k.shape != q.shape or k.dtype != q.dtype or k.device != q.device:
        raise ValueError(f"qk_norm_rope kernel: q {tuple(q.shape)} "
                         f"{q.dtype}, k {tuple(k.shape)} {k.dtype}")
    for x, w in ((q, q_weight), (k, k_weight)):
        why = _refusal(x, w)
        if why is not None:
            raise ValueError(f"qk_norm_rope kernel does not take {why}")
        if w is not None and w.shape != (d,):
            raise ValueError(f"qk_norm_rope kernel: weight "
                             f"{tuple(w.shape)} for head_dim {d}")
    n_table, cos, sin = 0, None, None
    if freqs is not None and freqs[0].shape[0] > 0:
        cos, sin = (_kernel_view(t[:s].to(torch.float32)) for t in freqs)
        if cos.shape[-1] != d or sin.shape != cos.shape:
            raise ValueError(f"qk_norm_rope kernel: tables "
                             f"{tuple(freqs[0].shape)}, "
                             f"{tuple(freqs[1].shape)} for head_dim {d}")
        n_table = cos.shape[0]
    q, k = _kernel_view(q), _kernel_view(k)
    wq, wk = (_kernel_view(w) if w is not None else None
              for w in (q_weight, k_weight))
    oq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    ok = torch.empty_like(oq)
    lib = cuda_lib.library("qk_rope")
    err = lib.hv_qk_norm_rope(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), q.stride(0),
        q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        wq.data_ptr() if wq is not None else None,
        wk.data_ptr() if wk is not None else None,
        cos.data_ptr() if cos is not None else None,
        sin.data_ptr() if sin is not None else None, n_table,
        oq.data_ptr(), ok.data_ptr(), b, s, h, float(eps),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, "qk_norm_rope")
    return oq, ok


def _qk_norm_rope(q, k, q_weight, k_weight, freqs: Freqs, eps: float):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return qk_norm_rope_plain(q, k, q_weight, k_weight, freqs, eps)
    if q.device.type != "cuda":
        raise ValueError(f"qk_norm_rope: the kernel takes CUDA tensors "
                         f"(the plain version CPU ones), not {q.device}")
    out = _launch(q, k, q_weight, k_weight, freqs, eps)
    qk_norm_rope.LAUNCHES += 1
    return out


class _QKNormRope(torch.autograd.Function):
    """The kernel forward, the autograd of the plain version backward
    (recomputed from the saved inputs, as `flash_attention_state`'s)."""

    @staticmethod
    def forward(ctx, q, k, q_weight, k_weight, cos, sin, eps):
        ctx.save_for_backward(q, k, q_weight, k_weight, cos, sin)
        ctx.eps = eps
        freqs = None if cos is None else (cos, sin)
        return _qk_norm_rope(q, k, q_weight, k_weight, freqs, eps)

    @staticmethod
    def backward(ctx, g_q, g_k):
        *xs, cos, sin = ctx.saved_tensors       # q, k, q_weight, k_weight
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [t if t is None else t.detach().requires_grad_(n)
                   for t, n in zip(xs, need)]
            outs = qk_norm_rope_plain(
                *ins, None if cos is None else (cos, sin), ctx.eps)
            outs, gs = zip(*((o, g) for o, g in zip(outs, (g_q, g_k))
                             if o.requires_grad))
            got = iter(torch.autograd.grad(
                outs, [t for t, n in zip(ins, need) if n], gs))
        return (*(next(got) if n else None for n in need), None, None, None)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor,
                 q_weight: Optional[torch.Tensor],
                 k_weight: Optional[torch.Tensor], freqs: Freqs,
                 eps: float = 1e-6, plain: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """QK-RMSNorm + RoPE of q and k [B, S, H, D] (any batch, token and head
    strides, e.g. the column views of a fused qkv projection): each row
    RMS-normalized with its weight ([D] or None), then token s < the
    table's rows rotated by row s of freqs = (cos, sin) [rows, D] (or
    None: no rotation). Returns contiguous (q, k) of the input's type.
    One kernel launch for the pair on CUDA tensors (bf16/fp16, head_dim
    64/128, weights of their type; others raise), the
    plain version on CPU tensors or with plain=True. Differentiable: under
    grad the backward recomputes the plain version."""
    if plain:
        return qk_norm_rope_plain(q, k, q_weight, k_weight, freqs, eps)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, q_weight, k_weight)):
        cos, sin = freqs if freqs is not None else (None, None)
        return _QKNormRope.apply(q, k, q_weight, k_weight, cos, sin, eps)
    return _qk_norm_rope(q, k, q_weight, k_weight, freqs, eps)


qk_norm_rope.LAUNCHES = 0
