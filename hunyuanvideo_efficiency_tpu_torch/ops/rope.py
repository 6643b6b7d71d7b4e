"""3-axis rotary position embedding for video tokens (JAX counterpart:
ops/rope.py; reference: hyvideo/modules/posemb_layers.py:191-310).

Per-axis 1-D frequencies concatenated along head_dim (rope_dim_list
(16, 56, 56) over (t, h, w)), real (cos, sin) tables interleave-duplicated
and applied as x*cos + rotate_half(x)*sin with pairs (x0, x1) -> (-x1, x0).
Tables are built in numpy in fp32; the rotation runs in fp32 and casts back.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch


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
