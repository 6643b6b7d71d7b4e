"""Causal 3D convolution and temporal resampling, channels-last (JAX
counterpart: ops/conv3d.py).

The reference VAE's CausalConv3d pads T by (kt-1, 0) and H/W by k//2 on
both sides, edge-replicate, so frame t never sees frames > t (reference:
hyvideo/vae/unet_causal_3d_blocks.py:49-75). Tensors stay NDHWC
[B, T, H, W, C] and kernels [kt, kh, kw, Cin, Cout] at these functions, as
in the JAX package. Stride-1 3x3x3 convs inside the K3 gate run the CUDA
kernel of ops/conv3d_cuda.py (K3); the rest (stride-2 downsamplers, the 16-
and 3-channel conv_in/conv_out, 1x1x1 shortcuts) use F.conv3d, as XLA
computed them outside any Pallas kernel. Nothing routes to the temporal-reuse
kernel B11 (`conv3d_stride1_v2`), as in JAX: the conv probe calls it. The
pad of every conv larger than 1x1x1 is a `vae.pad` span (utils/profiling.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import span
from .conv3d_cuda import conv3d_stride1, conv_applicable


def replicate_pad(x: torch.Tensor, t: Tuple[int, int], h: Tuple[int, int],
                  w: Tuple[int, int]) -> torch.Tensor:
    """Edge-replicate pad of the T, H, W axes of [B, T, H, W, C] in one
    gather: (before, after) per axis."""
    if not any(t + h + w):
        return x
    dev = x.device

    def idx(n, pad):
        return torch.arange(-pad[0], n + pad[1], device=dev).clamp_(0, n - 1)

    _, tt, hh, ww, _ = x.shape
    return x[:, idx(tt, t)[:, None, None], idx(hh, h)[None, :, None],
             idx(ww, w)[None, None, :]]


def replicate_pad_t(x: torch.Tensor, before: int, after: int = 0
                    ) -> torch.Tensor:
    """Edge-replicate padding along T of [B, T, H, W, C]."""
    return replicate_pad(x, (before, after), (0, 0), (0, 0))


def causal_conv3d(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  stride: Tuple[int, int, int] = (1, 1, 1),
                  impl: str = "auto") -> torch.Tensor:
    """Causal conv of [B, T, H, W, Cin] with kernel [kt, kh, kw, Cin, Cout]
    (exactly F.pad(..., (kw//2, kw//2, kh//2, kh//2, kt-1, 0),
    mode='replicate') then a valid conv).

    impl (JAX ops/conv3d.py:causal_conv3d): "auto" takes K3 inside its gate
    for fp16/bf16 inputs (the types K3 takes) and F.conv3d otherwise, fp32
    included; "cuda" (JAX's "pallas") takes K3 and raises outside the gate
    (K3 itself raises for fp32 on the card); "3d" takes F.conv3d. JAX's
    "t2d" is an XLA:TPU layout choice and is not carried over."""
    if impl not in ("auto", "cuda", "3d"):
        raise ValueError(f"causal_conv3d impl={impl!r}: expected 'auto', "
                         f"'cuda' or '3d'")
    kt, kh, kw = kernel.shape[:3]
    if kt * kh * kw > 1:
        with span("vae.pad"):
            xp = replicate_pad(x, (kt - 1, 0), (kh // 2, kh // 2),
                               (kw // 2, kw // 2))
    else:
        xp = x
    gated = conv_applicable(kernel.shape, stride)
    if impl == "cuda" and not gated:
        raise ValueError(f"the K3 conv gate rejects kernel "
                         f"{tuple(kernel.shape)} stride {tuple(stride)}")
    if impl == "cuda" or (impl == "auto" and gated
                          and x.dtype in (torch.float16, torch.bfloat16)):
        return conv3d_stride1(xp, kernel, bias)
    out = F.conv3d(xp.permute(0, 4, 1, 2, 3),
                   kernel.to(x.dtype).permute(4, 3, 0, 1, 2),
                   bias.to(x.dtype) if bias is not None else None,
                   stride=tuple(stride))
    return out.permute(0, 2, 3, 4, 1)


def conv3d_1x1(x: torch.Tensor, kernel: torch.Tensor,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pointwise conv as a matmul over channels; kernel [Cin, Cout]."""
    out = torch.matmul(x, kernel.to(x.dtype))
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def causal_avg_pool_t(x: torch.Tensor, kernel: int, stride: int
                      ) -> torch.Tensor:
    """Replicate-pad (k-1, 0) on T, then average k frames with stride s
    (reference: unet_causal_3d_blocks.py:767-783)."""
    x = replicate_pad_t(x, kernel - 1, 0)
    win = x.unfold(1, kernel, stride)          # [B, T', H, W, C, k]
    return win.sum(dim=-1) / float(kernel)


def interpolate_nearest_t(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest temporal upsample by an integer factor."""
    return x.repeat_interleave(scale, dim=1)


def _nearest_upsample_hw(x: torch.Tensor, sh: int, sw: int) -> torch.Tensor:
    if sh > 1:
        x = x.repeat_interleave(sh, dim=2)
    if sw > 1:
        x = x.repeat_interleave(sw, dim=3)
    return x


def upsample_nearest_causal_3d(x: torch.Tensor,
                               factor: Tuple[int, int, int]) -> torch.Tensor:
    """Causal nearest upsample: frame 0 spatially only, frames 1.. on
    (T, H, W); output T = (T-1)*ft + 1 (reference:
    unet_causal_3d_blocks.py:155-171)."""
    ft, fh, fw = factor
    first = _nearest_upsample_hw(x[:, :1], fh, fw)
    if x.shape[1] == 1:
        return first
    rest = x[:, 1:]
    if ft > 1:
        rest = rest.repeat_interleave(ft, dim=1)
    return torch.cat([first, _nearest_upsample_hw(rest, fh, fw)], dim=1)
