"""W8A8 linear (kernel B9): per-token int8 activations times per-output-
channel int8 weights, exact s32 accumulation, dequant + bias + activation
epilogue (JAX counterpart: ops/int8_matmul.py, and the numerics of
models/dit.py:_int8_linear_body).

  sx = max(max|x|, 1e-8) * (1/127) per row (amax in the input type),
  xq = round(x_f32 / sx) (ties to even), acc = xq . W8^T in s32,
  y  = act(acc * sx * scale_out + bias) in fp32, stored in x's type.

`w8a8_linear` launches the hand-written kernel (`csrc/w8a8_linear.cu`) on
CUDA tensors and runs `w8a8_linear_plain` on CPU tensors; any other device
raises. Every int8 linear of the port goes through it on the card, the
[B, 3072] modulation matvecs included (the JAX package sends rows < 1024
to its XLA body). `LAUNCHES` counts kernel launches. The weight is the
nn.Linear layout [N, K] (K contiguous), scale_out [N] fp32; a column slice
of the input (a row slice of a JAX kernel) is a strided view, not a copy.

Not ported: the JAX package's column-chunked XLA body and its temp budget
(`_int8_linear_colchunked`, `INT8_TEMP_BUDGET`, `set_int8_impl`,
`set_colchunk_unroll`); they bound an [L, n] s32 temp in 16 GB of TPU
memory, and the CUDA kernel never writes one.

Bound on the H100: 2*M*N*K int8 operations (1,979 TOP/s) against the bytes
of x, W and y (3.35 TB/s); see the source note in the .cu file.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_lib

# activations fusable into the store epilogue (keys of models.dit.ACT)
EPILOGUE_ACTS = {
    None: lambda y: y,
    "gelu": F.gelu,
    "gelu_tanh": lambda y: F.gelu(y, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
}
_ACT_CODE = {None: 0, "gelu": 1, "gelu_tanh": 2, "relu": 3, "silu": 4}
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 codes of x [..., K]: (xq int8, sx fp32 [..., 1])
    with sx = max(max|x|, 1e-8) * (1/127) and xq = round(x_f32 / sx)."""
    amax = x.abs().amax(dim=-1, keepdim=True).float()
    sx = amax.clamp_min(1e-8) * (1.0 / 127.0)
    return torch.round(x.float() / sx).to(torch.int8), sx


def w8a8_linear_plain(x, weight, scale_out, bias=None,
                      act: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch. x [..., K]; weight int8
    [N, K]; scale_out [N] fp32; bias [N] or None. The s32 product is taken
    in float64, exact for K <= 2^53 / 127^2."""
    xq, sx = quantize_rows(x)
    acc = torch.matmul(xq.double(), weight.double().t())
    y = acc.float() * sx * scale_out.float()
    if bias is not None:
        y = y + bias.float()
    return EPILOGUE_ACTS[act](y).to(x.dtype)


def w8a8_linear(x, weight, scale_out, bias=None,
                act: Optional[str] = None) -> torch.Tensor:
    """B9: y = act(dequant(quant(x) . weight^T) + bias), see the module
    docstring. Kernel on CUDA tensors, plain version on CPU tensors."""
    if act not in _ACT_CODE:
        raise ValueError(f"w8a8_linear: unsupported activation {act!r}")
    if x.device.type == "cpu":
        return w8a8_linear_plain(x, weight, scale_out, bias, act)
    if not x.is_cuda or not weight.is_cuda:
        raise ValueError(f"w8a8 kernel: x is on {x.device}, weight on "
                         f"{weight.device}, not a CUDA device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"w8a8 kernel takes bf16 or fp16 x, got {x.dtype}")
    if weight.dtype != torch.int8:
        raise TypeError(f"w8a8 kernel takes an int8 weight, got "
                        f"{weight.dtype}")
    n, k = weight.shape
    if x.shape[-1] != k or n % 128 or k % 128:
        raise ValueError(f"w8a8 kernel: x {tuple(x.shape)} against weight "
                         f"{tuple(weight.shape)}; N and K must be multiples "
                         f"of 128")
    if weight.stride(1) != 1 or weight.stride(0) % 16 \
            or weight.data_ptr() % 16:
        weight = weight.contiguous()
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    so = scale_out.float().contiguous()
    b = bias.float().contiguous() if bias is not None else None
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = cuda_lib.library("w8a8_linear")
    err = lib.hv_w8a8_linear(
        _DTYPE_CODE[x.dtype], _ACT_CODE[act], x2.data_ptr(), x2.stride(0),
        weight.data_ptr(), weight.stride(0), so.data_ptr(),
        b.data_ptr() if b is not None else None, out.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), m, n, k, cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "w8a8 linear")
    w8a8_linear.LAUNCHES += 1
    return out.reshape(*lead, n)


w8a8_linear.LAUNCHES = 0
