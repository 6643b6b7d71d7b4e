"""Attention paths and mask construction (JAX counterpart: ops/attention.py).

Static [img | txt] sequences with an additive key-padding bias replace the
reference's varlen packing (reference: hyvideo/modules/attenion.py:34-156):
padding keys are masked for every valid query and padded outputs never
reach the final layer, so valid positions match exactly.

* `sdpa_attention`: full score matrix, fp32 softmax (token refiner, VAE
  mid-block, text towers) — plain matmul + softmax, as XLA computed it.
* `chunked_attention`: online softmax over query and key chunks, with an
  optional block bias (the VAE mid-block's frame-causal mask at large L).
* `flash`: the hand-written kernels, through `flash_attention_vjp`
  (ops/flash_backward.py): the LSE-free kernels of ops/flash_attention.py
  when no gradient is wanted, the forward-with-LSE and the two backward
  kernels under differentiation.
* `flash_int8`: the int8 Q.K^T kernels of ops/flash_attention.py
  (inference only: no backward).
* `sta` / `sta_int8` (joint_attention only): sliding-tile attention for
  the image queries, ops/sta.py (bf16, or int8 Q.K^T), differentiable
  through `sta_joint_attention_trainable`; it needs the (T, H, W) patch
  grid.

Layout: q/k/v [B, S, H, D]; outputs [B, S, H*D].
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = -1e30


def padding_key_bias(text_mask: torch.Tensor, img_len: int) -> torch.Tensor:
    """Key bias [B, 1, 1, img_len + text_len]: 0 for img tokens and valid
    text tokens, NEG_INF for text padding."""
    b = text_mask.shape[0]
    valid = torch.cat([torch.ones((b, img_len), dtype=torch.bool,
                                  device=text_mask.device),
                       text_mask.bool()], dim=1)
    return text_key_bias(valid)


def text_key_bias(text_mask: torch.Tensor) -> torch.Tensor:
    """Key bias [B, 1, 1, text_len] over text keys only."""
    bias = torch.where(text_mask.bool(), 0.0, NEG_INF).to(torch.float32)
    return bias[:, None, None, :]


def joint_key_bias(txt_bias: Optional[torch.Tensor], img_len: int
                   ) -> Optional[torch.Tensor]:
    """Key bias [B, 1, 1, img_len + text_len] of the joint [img | txt]
    keys: zeros over the image keys, then the text keys' bias."""
    if txt_bias is None:
        return None
    zeros = torch.zeros((txt_bias.shape[0], 1, 1, img_len),
                        dtype=torch.float32, device=txt_bias.device)
    return torch.cat([zeros, txt_bias.float()], dim=-1)


def sdpa_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention, fp32 scores and softmax, probabilities rounded to
    v's type before P.V. q/k/v [B, S, H, D] -> [B, Sq, H*D]."""
    b, sq, h, d = q.shape
    scale = scale if scale is not None else d ** -0.5
    qf = q.float().transpose(1, 2) * scale
    kf = k.float().transpose(1, 2)
    scores = torch.matmul(qf, kf.transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype), v.transpose(1, 2))
    return out.transpose(1, 2).reshape(b, sq, h * d)


def chunked_attention(q, k, v, key_bias: Optional[torch.Tensor] = None,
                      block_bias_fn: Optional[Callable] = None,
                      scale: Optional[float] = None, q_chunk: int = 1024,
                      k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over chunks; O(q_chunk * k_chunk) scores
    live. key_bias [B, 1, 1, Sk]; block_bias_fn(q_idx [qc, 1], k_idx
    [1, kc]) -> additive [qc, kc] bias (e.g. frame-causal)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    outs = []
    for q0 in range(0, sq, q_chunk):
        qf = q[:, q0:q0 + q_chunk].float().transpose(1, 2) * scale
        nq = qf.shape[2]
        m = torch.full((b, h, nq), NEG_INF, device=dev)
        l = torch.zeros((b, h, nq), device=dev)
        acc = torch.zeros((b, h, nq, d), device=dev)
        q_idx = torch.arange(q0, q0 + nq, device=dev)[:, None]
        for k0 in range(0, sk, k_chunk):
            kf = k[:, k0:k0 + k_chunk].float().transpose(1, 2)
            vf = v[:, k0:k0 + k_chunk].float().transpose(1, 2)
            s = torch.matmul(qf, kf.transpose(-1, -2))
            if key_bias is not None:
                s = s + key_bias[..., k0:k0 + k_chunk].float()
            if block_bias_fn is not None:
                k_idx = torch.arange(k0, k0 + kf.shape[2], device=dev)[None]
                s = s + block_bias_fn(q_idx, k_idx)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(p, vf)
            m = m_new
        outs.append((acc / l.clamp_min(1e-37)[..., None]).transpose(1, 2))
    out = torch.cat(outs, dim=1)
    return out.to(v.dtype).reshape(b, sq, h * d)


def frame_causal_block_bias(n_hw: int) -> Callable:
    """VAE mid-block mask: token i attends token j iff frame(j) <= frame(i)
    (reference: unet_causal_3d_blocks.py:38-46)."""

    def fn(q_idx, k_idx):
        keep = (k_idx // n_hw) <= (q_idx // n_hw)
        return torch.where(keep, 0.0, NEG_INF).to(torch.float32)

    return fn


def attention(q, k, v, mode: str = "auto", bias=None, key_bias=None,
              scale: Optional[float] = None, bound_mode: str = "auto",
              score_bound=None, plain: bool = False) -> torch.Tensor:
    """Dispatch: "flash" (the CUDA kernels; their plain versions on CPU
    tensors), "flash_int8", "sdpa", "chunked"; "auto" is "flash" at every
    length. plain=True runs flash_int8 on its plain version."""
    if mode == "auto":
        mode = "flash"
    if mode == "sdpa":
        return sdpa_attention(q, k, v, bias=bias if bias is not None
                              else key_bias, scale=scale)
    if mode == "chunked":
        return chunked_attention(q, k, v, key_bias=key_bias, scale=scale)
    if mode == "flash":
        from .flash_backward import flash_attention_vjp

        return flash_attention_vjp(q, k, v, key_bias, score_bound, scale,
                                   bound_mode=bound_mode)
    if mode == "flash_int8":
        if torch.is_grad_enabled() and any(x.requires_grad
                                           for x in (q, k, v)):
            raise NotImplementedError(
                "attention mode 'flash_int8' is inference only: it has no "
                "backward (train with 'flash', 'sta' or 'sdpa')")
        # JAX ops/attention.py:298-308: "static" keeps the static-offset
        # kernel; anything else means the safe running max
        from .flash_attention import flash_attention_int8

        return flash_attention_int8(
            q, k, v, key_bias=key_bias, scale=scale,
            bound_mode="static" if bound_mode == "static" else "running",
            score_bound=score_bound, plain=plain)
    if mode in ("sta", "sta_int8"):
        raise ValueError(f"mode={mode!r} needs the image/text split and the "
                         f"token grid: call joint_attention")
    raise NotImplementedError(
        f"attention mode {mode!r} is not ported to the PyTorch package")


def joint_attention(img_q, img_k, img_v, txt_q, txt_k, txt_v,
                    txt_bias: Optional[torch.Tensor], mode: str = "auto",
                    scale: Optional[float] = None, bound_mode: str = "auto",
                    score_bound=None, token_grid=None, sta_tile=(4, 8, 8),
                    sta_window=(3, 3, 3), plain: bool = False):
    """Joint attention over [img | txt] tokens on one device; returns
    (img_out, txt_out), each [B, S, H*D].

    mode="sta" runs Sliding Tile Attention (ops/sta.py) for the image
    queries over the `token_grid` = (T, H, W) patch grid; "sta_int8" the
    same with int8 Q.K^T (it needs bound_mode "static", which the DiT grants
    under QK-norm). plain routes the STA image queries and flash_int8 to
    their plain versions (a reference for checks)."""
    if mode in ("sta", "sta_int8"):
        if token_grid is None:
            raise ValueError(f"attn_mode={mode!r} requires token_grid")
        from .sta import sta_joint_attention_trainable

        return sta_joint_attention_trainable(
            img_q, img_k, img_v, txt_q, txt_k, txt_v, txt_bias,
            grid=tuple(token_grid), tile=tuple(sta_tile),
            window=tuple(sta_window), scale=scale, bound_mode=bound_mode,
            qk_int8=mode == "sta_int8", score_bound=score_bound, plain=plain)
    img_len = img_q.shape[1]
    q = torch.cat([img_q, txt_q], dim=1)
    k = torch.cat([img_k, txt_k], dim=1)
    v = torch.cat([img_v, txt_v], dim=1)
    out = attention(q, k, v, mode=mode,
                    key_bias=joint_key_bias(txt_bias, img_len), scale=scale,
                    bound_mode=bound_mode, score_bound=score_bound,
                    plain=plain)
    return out[:, :img_len], out[:, img_len:]
