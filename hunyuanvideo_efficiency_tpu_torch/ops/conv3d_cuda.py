"""Implicit-GEMM stride-1 3x3x3 conv of a pre-padded NDHWC input (kernels
K3 and B11).

Counterpart of the JAX package's ops/conv3d_pallas.py. `conv3d_stride1`
runs the CUDA kernel of `csrc/conv3d.cu` (which replaces the Pallas kernel
`_conv_kernel`) and `conv3d_stride1_v2` the one of `csrc/conv3d_v2.cu`
(which replaces `_conv_kernel_v2`: the same function, each input frame read
once per sweep over T) on CUDA tensors; both run the plain PyTorch version
`conv3d_stride1_plain` on CPU tensors; any other device raises. Each
wrapper's `LAUNCHES` counts its kernel's launches.

Bound on the H100: 2*27*Cin*Cout*B*T*H*W tensor-core operations (989
TFLOP/s fp16) against one read of the input and one write of the output,
so the kernel is bound by operations; see the .cu source notes and
`csrc/conv3d_tile.cuh`, the wgmma + TMA main loop both kernels share. Both
take a tile of 256 output pixels whose width `conv_tile` picks from the
frame's H and W; `conv_block_n` picks K3's output channels a block.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}


def conv_applicable(kernel_shape, stride) -> bool:
    """Shape gate routing `ops.conv3d.causal_conv3d` to K3: a stride-1
    3x3x3 conv with Cin and Cout multiples of 128 (the TPU gate's channel
    conditions; its H % 8 condition is dropped because the kernel masks
    the H and W tile edges)."""
    kt, kh, kw, cin, cout = kernel_shape
    return (tuple(stride) == (1, 1, 1) and (kt, kh, kw) == (3, 3, 3)
            and cin % 128 == 0 and cout % 128 == 0)


TILE_WIDTHS = (8, 16, 32)    # the kernels' pixel tiles: 256 / bw rows x bw


def conv_tile(h: int, w: int) -> int:
    """Width bw of the kernels' 256-pixel tile (256 / bw rows x bw columns)
    for an H x W output frame: the one whose tiles cover the fewest pixels
    past the frame's edges (a ragged tile's loads are zero-filled and its
    products wasted); on a tie 16, then the narrower."""
    def covered(bw):
        bh = 256 // bw
        return -(-h // bh) * bh * -(-w // bw) * bw

    return min(TILE_WIDTHS, key=lambda bw: (covered(bw), bw != 16, bw))


def conv_block_n(b: int, t: int, h: int, w: int, cout: int,
                 sms: int = 132) -> int:
    """Output channels a K3 block takes, 128 or 64, for a [b, t, h, w] x
    cout output on a card of `sms` multiprocessors (one block each): 64
    where halving the blocks' width cuts the time of the last, partly filled
    wave by a fifth or more (short stages, e.g. the decoder's 512-channel
    ones at 32 x 32 x 9: 144 blocks of 128 channels on 132 SMs); else 128,
    which reads half the input bytes an operation."""
    bh = 256 // conv_tile(h, w)
    blocks = b * t * -(-h // bh) * -(-w // (256 // bh))

    def waves(bn):
        return -(-blocks * (cout // bn) // sms) * bn

    return 64 if waves(64) <= 0.8 * waves(128) else 128


def conv3d_stride1_plain(xp: torch.Tensor, kernel: torch.Tensor,
                         bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: the 27 taps as fp32 matmuls over shifted views.
    xp [B, T+2, H+2, W+2, Cin], kernel [3, 3, 3, Cin, Cout] ->
    [B, T, H, W, Cout] in xp's dtype (bias added in fp32, one rounding)."""
    b, tp, hp, wp, cin = xp.shape
    kt, kh, kw, _, cout = kernel.shape
    t, h, w = tp - kt + 1, hp - kh + 1, wp - kw + 1
    xf = xp.float()
    wf = kernel.float()
    out = torch.zeros((b, t, h, w, cout), dtype=torch.float32,
                      device=xp.device)
    for dt in range(kt):
        for dh in range(kh):
            for dw in range(kw):
                out += torch.matmul(xf[:, dt:dt + t, dh:dh + h, dw:dw + w],
                                    wf[dt, dh, dw])
    if bias is not None:
        out += bias.float()
    return out.to(xp.dtype)


def _launch(xp, kernel, bias, v2=False):
    if not xp.is_cuda or not kernel.is_cuda:
        raise ValueError(f"conv3d kernel: input on {xp.device}, weights on "
                         f"{kernel.device}; both must be on a CUDA device")
    if xp.dtype not in _DTYPE_CODE:
        raise TypeError(f"conv3d kernel takes fp16 or bf16, got {xp.dtype}")
    b, tp, hp, wp, cin = xp.shape
    if tuple(kernel.shape[:4]) != (3, 3, 3, cin) or kernel.shape[4] % 128 \
            or cin % 128:
        raise ValueError(f"conv3d kernel: bad weight {tuple(kernel.shape)} "
                         f"for input {tuple(xp.shape)}")
    cout = kernel.shape[4]
    t, h, w = tp - 2, hp - 2, wp - 2
    xp = xp.contiguous()
    # [3, 3, 3, Cout, Cin]: Cin contiguous, the K-major wgmma B operand
    wt = kernel.to(xp.dtype).permute(0, 1, 2, 4, 3).contiguous()
    bf = bias.to(torch.float32).contiguous() if bias is not None else None
    out = torch.empty((b, t, h, w, cout), dtype=xp.dtype, device=xp.device)
    name = "conv3d_v2" if v2 else "conv3d"
    lib = cuda_lib.library(name)
    fn = lib.hv_conv3d_stride1_v2 if v2 else lib.hv_conv3d_stride1
    args = [b, t, h, w, cin, cout, conv_tile(h, w)]
    if not v2:
        sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
        args.append(conv_block_n(b, t, h, w, cout, sms))
    err = fn(_DTYPE_CODE[xp.dtype], xp.data_ptr(), wt.data_ptr(),
             bf.data_ptr() if bf is not None else None, out.data_ptr(),
             *args, cuda_lib.stream_ptr(xp.device))
    cuda_lib.check(err, name)
    return out


def conv3d_stride1(xp: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3 wrapper. xp [B, T+2, H+2, W+2, Cin] (already causally padded),
    kernel [3, 3, 3, Cin, Cout], bias [Cout] -> [B, T, H, W, Cout]."""
    if xp.device.type == "cpu":
        return conv3d_stride1_plain(xp, kernel, bias)
    out = _launch(xp, kernel, bias)
    conv3d_stride1.LAUNCHES += 1
    return out


conv3d_stride1.LAUNCHES = 0


def conv3d_stride1_v2(xp: torch.Tensor, kernel: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B11 wrapper, K3's contract: xp [B, T+2, H+2, W+2, Cin] (already
    causally padded), kernel [3, 3, 3, Cin, Cout] with Cin and Cout
    multiples of 128, bias [Cout] -> [B, T, H, W, Cout]."""
    if xp.device.type == "cpu":
        return conv3d_stride1_plain(xp, kernel, bias)
    out = _launch(xp, kernel, bias, v2=True)
    conv3d_stride1_v2.LAUNCHES += 1
    return out


conv3d_stride1_v2.LAUNCHES = 0
