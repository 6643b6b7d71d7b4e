"""W8A8 linear (kernel B9): per-token int8 activations times per-output-
channel int8 weights, exact s32 accumulation, dequant + bias + activation
epilogue (JAX counterpart: ops/int8_matmul.py, and the numerics of
models/dit.py:_int8_linear_body).

  sx = max(max|x|, 1e-8) * (1/127) per row (amax in the input type),
  xq = round(x_f32 / sx) (ties to even), acc = xq . W8^T in s32,
  y  = act(acc * sx * scale_out + bias) in fp32, stored in x's type.

`w8a8_linear` launches the hand-written kernels (`csrc/w8a8_linear.cu`:
a quantizing pre-pass, then a persistent s8 wgmma GEMM on a TMA ring) on
CUDA tensors and runs `w8a8_linear_plain` on CPU tensors; any other device
raises. Every int8 linear of the port goes through it on the card, the
[B, 3072] modulation matvecs included (the JAX package sends rows < 1024
to its XLA body). `LAUNCHES` counts calls (one each, however many kernels
a call launches). The weight is the nn.Linear layout [N, K] (K
contiguous), scale_out [N] fp32; a column slice of the input (a row slice
of a JAX kernel) is a strided view, not a copy.

`plan_w8a8` picks the GEMM's schedule on the host from (M, N, K, SM
count): the tile, the split of K and the persistent grid; `plan_segments`
lists each CTA's work in the kernel's order (the CPU tests check that it
covers the output once).

Not ported: the JAX package's column-chunked XLA body and its temp budget
(`_int8_linear_colchunked`, `INT8_TEMP_BUDGET`, `set_int8_impl`,
`set_colchunk_unroll`); they bound an [L, n] s32 temp in 16 GB of TPU
memory, and the CUDA kernel never writes one.

Two arms serve a row-parallel linear, whose K is split over ranks (the
tensor-parallel Llama tower's o_proj and down_proj, models/text/llama.py):
`row_scale` gives sx (the amax of the whole row, all-reduced over the
ranks), so that every rank quantizes its K slice with the codes one rank
would give, and `s32=True` turns the epilogue off and returns the s32 sums,
which the ranks add as integers (exact) before the dequant.

Bound on the H100: 2*M*N*K int8 operations (1,979 TOP/s) against the bytes
of x, W and y (3.35 TB/s); see the source note in the .cu file.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional, Tuple

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
S32_CODE = 5    # the kernel's act code for the s32 arm (epilogue off)
_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1}

BK = 128        # the GEMM's K step (bytes); N and K are multiples of 128
GROUP = 8       # row tiles per raster group (csrc/w8a8_linear.cu: GROUP)
SHORT_M = 64    # rows up to which the short schedule streams the weight
TILES = ((128, 256), (128, 128), (64, 128))   # (BM, BN) the kernel takes


def row_scales(amax: torch.Tensor) -> torch.Tensor:
    """sx = max(amax, 1e-8) * (1/127) in fp32: the row scale of an amax."""
    return amax.float().clamp_min(1e-8) * (1.0 / 127.0)


def quantize_rows(x: torch.Tensor, sx: Optional[torch.Tensor] = None):
    """Per-row symmetric int8 codes of x [..., K]: (xq int8, sx fp32 [..., 1])
    with sx = max(max|x|, 1e-8) * (1/127), or the given `sx` [..., 1], and
    xq = clip(round(x_f32 / sx), -127, 127) (the clip binds only under a
    given scale below the row's own)."""
    if sx is None:
        sx = row_scales(x.abs().amax(dim=-1, keepdim=True))
    return torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8), sx


def w8a8_linear_plain(x, weight, scale_out, bias=None,
                      act: Optional[str] = None, *,
                      row_scale: Optional[torch.Tensor] = None,
                      s32: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch. x [..., K]; weight int8
    [N, K]; scale_out [N] fp32; bias [N] or None; row_scale [...] fp32, the
    given sx; s32=True returns the int32 sums (no epilogue, scale_out not
    read). The s32 product is taken in float64, exact for K <= 2^53 /
    127^2."""
    xq, sx = quantize_rows(x, None if row_scale is None
                           else row_scale.float()[..., None])
    acc = torch.matmul(xq.double(), weight.double().t())
    if s32:
        return acc.to(torch.int32)
    y = acc.float() * sx * scale_out.float()
    if bias is not None:
        y = y + bias.float()
    return EPILOGUE_ACTS[act](y).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class W8A8Plan:
    """The GEMM's schedule: tiles of bm x bn, K in `split` parts of whole
    128-byte steps, `grid` persistent CTAs walking the units."""
    bm: int
    bn: int
    split: int
    grid: int
    m_tiles: int
    n_tiles: int
    k_steps: int

    @property
    def units(self) -> int:
        return self.m_tiles * self.n_tiles * self.split


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=4096)
def plan_w8a8(m: int, n: int, k: int, sms: int) -> W8A8Plan:
    """The schedule of an [m, k] x [n, k]^T call on a card of `sms` SMs.

    m <= 64 (the modulation matvecs): 64 x 128 tiles and K split in its
    single 128-byte steps; each CTA takes an equal contiguous range of the
    (tile, step) units (stream-K), so that the weight read, which is the
    bound, is spread evenly over every SM, and a CTA flushes partial sums
    about twice. Otherwise no split, and the tile of the least modeled
    time: rounds of tiles over the SMs times a tile's cost, its products
    (bm * bn) plus its operand bytes (64 * (bm + bn), what makes a narrow
    tile dearer a product); ties go to the wider tile."""
    steps = k // BK
    if m <= SHORT_M:
        n_tiles = _cdiv(n, 128)
        return W8A8Plan(64, 128, steps, min(n_tiles * steps, sms), 1,
                        n_tiles, steps)

    def cost(tile):
        bm, bn = tile
        rounds = _cdiv(_cdiv(m, bm) * _cdiv(n, bn), sms)
        return rounds * (bm * bn + 64 * (bm + bn))

    bm, bn = min(TILES, key=cost)
    m_tiles, n_tiles = _cdiv(m, bm), _cdiv(n, bn)
    return W8A8Plan(bm, bn, 1, min(m_tiles * n_tiles, sms), m_tiles,
                    n_tiles, steps)


def plan_segments(plan: W8A8Plan) -> Iterator[Tuple[int, int, int, int, int]]:
    """The plan's work in the kernel's order (csrc/w8a8_linear.cu:
    units_begin, segment_of): (CTA, first row, first column, first K byte,
    end K byte) per segment. Unit u is tile u // split (row tiles fastest
    within groups of GROUP) and part u % split of its K steps; with split
    1 CTA c takes units c, c + grid, ...; with split > 1 the contiguous
    units [c * units // grid, (c + 1) * units // grid), the parts of one
    tile among them as one segment."""
    for c in range(plan.grid):
        if plan.split == 1:
            u, end = c, plan.units
        else:
            u = c * plan.units // plan.grid
            end = (c + 1) * plan.units // plan.grid
        while u < end:
            tile, part = divmod(u, plan.split)
            last = part if plan.split == 1 else \
                min(end - tile * plan.split, plan.split) - 1
            grp, r = divmod(tile, GROUP * plan.n_tiles)
            rows = min(plan.m_tiles - grp * GROUP, GROUP)
            mi, ni = grp * GROUP + r % rows, r // rows
            k0 = part * plan.k_steps // plan.split
            k1 = (last + 1) * plan.k_steps // plan.split
            yield c, mi * plan.bm, ni * plan.bn, k0 * BK, k1 * BK
            u = u + plan.grid if plan.split == 1 \
                else tile * plan.split + last + 1


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _prepass_launch(x2: torch.Tensor):
    """The pre-pass kernel alone on x2 [M, K]: (xq int8 [M, K], sx fp32
    [M])."""
    m, k = x2.shape
    xq = torch.empty((m, k), dtype=torch.int8, device=x2.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x2.device)
    err = cuda_lib.library("w8a8_linear").hv_w8a8_quantize(
        _DTYPE_CODE[x2.dtype], x2.data_ptr(), x2.stride(0), xq.data_ptr(),
        sx.data_ptr(), 0, None, 0, m, k, cuda_lib.stream_ptr(x2.device))
    cuda_lib.check(err, "w8a8 quantization pre-pass")
    return xq, sx


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [..., K] as [M, K] rows the pre-pass takes (unit K stride,
    16-byte aligned rows)."""
    x2 = x.reshape(-1, k)
    if x2.stride(1) != 1 or x2.stride(0) % 8 or x2.data_ptr() % 16:
        x2 = x2.contiguous()
    return x2


def _aligned(v: torch.Tensor) -> torch.Tensor:
    """v, or a copy of it if it is not 8-byte aligned (the epilogue reads
    scale_out and bias in pairs of columns)."""
    return v.clone() if v.data_ptr() % 8 else v


def w8a8_prepass(x: torch.Tensor):
    """B9's quantization pre-pass alone, for checking and timing it:
    (codes int8 [..., K], scales fp32 [...]) as `quantize_rows` gives them
    (its scales without the last axis). The kernel on CUDA tensors (bf16 or
    fp16, K a multiple of 8), `quantize_rows` on CPU tensors."""
    if x.device.type == "cpu":
        xq, sx = quantize_rows(x)
        return xq, sx[..., 0]
    if not x.is_cuda or x.dtype not in _DTYPE_CODE or x.shape[-1] % 8:
        raise ValueError(f"w8a8 pre-pass takes bf16/fp16 CUDA rows of a "
                         f"multiple of 8, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    k = x.shape[-1]
    xq, sx = _prepass_launch(_rows(x, k))
    return xq.reshape(x.shape), sx.reshape(x.shape[:-1])


def w8a8_linear(x, weight, scale_out, bias=None,
                act: Optional[str] = None, *,
                row_scale: Optional[torch.Tensor] = None,
                s32: bool = False) -> torch.Tensor:
    """B9: y = act(dequant(quant(x) . weight^T) + bias), see the module
    docstring; row_scale [...] (x's leading shape, fp32) quantizes with the
    caller's sx, s32=True returns the int32 sums [..., N] (no bias, act or
    scale_out). Kernel on CUDA tensors, plain version on CPU tensors."""
    if act not in _ACT_CODE:
        raise ValueError(f"w8a8_linear: unsupported activation {act!r}")
    if s32 and (bias is not None or act is not None):
        raise ValueError("w8a8_linear: the s32 arm takes no bias and no "
                         "activation")
    if row_scale is not None and row_scale.shape != x.shape[:-1]:
        raise ValueError(f"w8a8_linear: row_scale {tuple(row_scale.shape)} "
                         f"against x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return w8a8_linear_plain(x, weight, scale_out, bias, act,
                                 row_scale=row_scale, s32=s32)
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
    if not x.is_cuda or not weight.is_cuda:
        raise ValueError(f"w8a8 kernel: x is on {x.device}, weight on "
                         f"{weight.device}, not a CUDA device")
    if weight.stride(1) != 1 or weight.stride(0) % 16 \
            or weight.data_ptr() % 16:
        weight = weight.contiguous()
    lead = x.shape[:-1]
    x2 = _rows(x, k)
    m = x2.shape[0]
    plan = plan_w8a8(m, n, k, _sm_count(x.device))
    so = _aligned(scale_out.float().contiguous())
    bias_type = 0
    if bias is not None:   # fp32 or x's type go as they are
        bias_type = 2 if bias.dtype == x.dtype else 1
        bias = _aligned((bias if bias_type == 2 else bias.float())
                        .contiguous())
    # one scratch buffer: the codes [m, k], the row scales [m] and, with
    # split-K, the s32 sums [m, n] and the tile counters
    sx_at = _cdiv(m * k, 16) * 16
    ws_at = sx_at + _cdiv(4 * m, 16) * 16
    ws_bytes = 4 * (m * n + plan.m_tiles * plan.n_tiles + 3) \
        if plan.split > 1 else 0
    scratch = torch.empty(ws_at + ws_bytes, dtype=torch.uint8,
                          device=x.device)
    base = scratch.data_ptr()
    sx_ptr = base + sx_at
    if row_scale is not None:
        row_scale = row_scale.reshape(m).float().contiguous()
        sx_ptr = row_scale.data_ptr()
    out = torch.empty((m, n), dtype=torch.int32 if s32 else x.dtype,
                      device=x.device)
    err = cuda_lib.library("w8a8_linear").hv_w8a8_linear(
        _DTYPE_CODE[x.dtype], S32_CODE if s32 else _ACT_CODE[act],
        x2.data_ptr(), x2.stride(0), weight.data_ptr(), weight.stride(0),
        so.data_ptr(), bias.data_ptr() if bias is not None else None,
        bias_type, out.data_ptr(), base, sx_ptr,
        base + ws_at if ws_bytes else None, int(row_scale is not None), m, n,
        k, plan.bm, plan.bn, plan.split, plan.grid,
        cuda_lib.stream_ptr(x.device))
    cuda_lib.check(err, "w8a8 linear")
    w8a8_linear.LAUNCHES += 1
    return out.reshape(*lead, n)


w8a8_linear.LAUNCHES = 0
