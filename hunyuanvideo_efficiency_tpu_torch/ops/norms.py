"""Normalization ops with fp32 statistics (JAX counterpart: ops/norms.py).

Each computes its statistics in float32 whatever the input type and casts
back, as the reference's norm layers do
(reference: hyvideo/modules/norm_layers.py:5-59).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; the normalized row is cast back to x's
    type before the affine scale."""
    xf = x.float()
    normed = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
              ).to(x.dtype)
    if weight is not None:
        normed = normed * weight
    return normed


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis; affine applied in fp32."""
    out = F.layer_norm(x.float(), x.shape[-1:],
                       weight.float() if weight is not None else None,
                       bias.float() if bias is not None else None, eps)
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, num_groups: int,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of channels-last x [B, ..., C]: statistics per (batch,
    group) over all positions and the group's channels, folded with the
    affine into a per-(batch, group) scale and shift applied in x's type."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // num_groups
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xg = x.reshape(b, -1, num_groups, cg)
    var, mean = torch.var_mean(xg.float(), dim=(1, 3), keepdim=True,
                               correction=0)
    scale = torch.rsqrt(var + eps)                   # [B, 1, G, 1]
    shift = -mean * scale
    if weight is not None:
        wg = weight.float().reshape(1, 1, num_groups, cg)
        scale = scale * wg
        shift = shift * wg
    if bias is not None:
        shift = shift + bias.float().reshape(1, 1, num_groups, cg)
    out = xg * scale.to(x.dtype) + shift.to(x.dtype)
    return out.reshape(x.shape)
