"""Weight storage tiers of the DiT block linears and the Llama tower (JAX
counterpart: ops/quantization.py; reference:
hyvideo/modules/fp8_optimization.py).

* fp8 (E4M3): one scale per tensor, storage only; the weight is
  dequantized to the activation type and multiplied in bf16, as the JAX
  package does outside Pallas.
* int8: one scale per output channel, round-half-even codes clipped to
  +-127; computed by the W8A8 kernel (ops/int8_matmul.py).
* int4 (the adaLN modulation linears): one scale per output channel, codes
  in [-7, 7] packed two per byte along the output axis (even outputs in the
  low nibble); storage only, dequantized and multiplied in bf16.

Each tier is a small module with the nn.Linear state-dict names (`weight`,
`bias`) plus `scale` (fp8) or `scale_out` (int8, int4); weights keep the
[out, in] layout. `linear()` applies an nn.Linear or any of them, with
optional output (column) and input (row) slices: an output slice slices
`scale_out` with the weight, an input slice keeps it whole, as the JAX
block code's _col_slice/_row_slice.

The converters replace modules in place, one at a time, so that a
full-width bf16 DiT and its quantized copy never both stay alive; they
cover only double_blocks/single_blocks (embedders and the final layer stay
in the model type) and stack in the JAX order: fp8, then int8 of the
dequantized fp8 weights, then int4 of whatever the modulation linears hold.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .int8_matmul import EPILOGUE_ACTS, w8a8_linear, w8a8_linear_plain

FP8_E4M3_MAX = 448.0
QUANT_BLOCK_KEYS = ("double_blocks", "single_blocks")
MODULATION_KEYS = ("modulation", "img_mod", "txt_mod")


def quantize_tensor_fp8(w: torch.Tensor):
    """Per-tensor E4M3: (codes float8_e4m3fn, scale 0-d fp32) with
    scale = max(max|w|, 1e-12) / 448."""
    wf = w.float()
    scale = wf.abs().amax().clamp_min(1e-12) / FP8_E4M3_MAX
    q = (wf / scale).clamp(-FP8_E4M3_MAX, FP8_E4M3_MAX)
    return q.to(torch.float8_e4m3fn), scale


def quantize_tensor_int8(w: torch.Tensor):
    """Per-output-channel int8 of w [out, in]: (codes int8, scale_out [out]
    fp32) with scale = max(max|w|, 1e-12) / 127 over the input axis and
    codes clip(round(w / scale), -127, 127)."""
    wf = w.float()
    scale = wf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0]


def quantize_tensor_int4(w: torch.Tensor):
    """Per-output-channel int4 of w [out, in] (out even): (packed uint8
    [out / 2, in], scale_out [out] fp32); codes clip(round(w / scale), -7,
    7) with scale = max(max|w|, 1e-12) / 7, output 2j in the low nibble of
    row j and output 2j + 1 in its high nibble."""
    if w.shape[0] % 2:
        raise ValueError("int4 packing needs an even out dim")
    wf = w.float()
    scale = wf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 7.0
    q = torch.round(wf / scale).clamp(-7, 7).to(torch.int16)
    packed = (q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)
    return packed.to(torch.uint8), scale[:, 0]


def dequantize_int4(packed: torch.Tensor, scale_out: torch.Tensor,
                    dtype) -> torch.Tensor:
    """uint8-packed int4 [out / 2, in] -> dense [out, in] in `dtype`."""
    p = packed.to(torch.int16)
    low, high = p & 0xF, p >> 4
    low = torch.where(low > 7, low - 16, low)
    high = torch.where(high > 7, high - 16, high)
    q = torch.stack([low, high], dim=1).reshape(-1, packed.shape[1])
    return (q.float() * scale_out.float()[:, None]).to(dtype)


class _QuantLinear(nn.Module):
    """Common part of the tiers: `weight` codes [out, in] (packed for int4)
    and the scales as buffers, `bias` [out] as a parameter (or None)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: Optional[torch.Tensor]):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.bias = (nn.Parameter(bias, requires_grad=False)
                     if bias is not None else None)

    def dense_weight(self) -> torch.Tensor:
        """The dequantized weight [out, in] in fp32."""
        raise NotImplementedError

    def forward(self, x):
        return linear(self, x)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


class Fp8Linear(_QuantLinear):
    """E4M3 codes with one fp32 `scale` (0-d)."""

    def __init__(self, weight, scale, bias=None):
        super().__init__(weight.shape[1], weight.shape[0], bias)
        self.register_buffer("weight", weight)
        self.register_buffer("scale", scale.reshape(()).float())

    def dense_weight(self):
        return self.weight.float() * self.scale


class Int8Linear(_QuantLinear):
    """int8 codes with a per-output-channel fp32 `scale_out` [out]; runs
    the W8A8 kernel."""

    def __init__(self, weight, scale_out, bias=None):
        super().__init__(weight.shape[1], weight.shape[0], bias)
        self.register_buffer("weight", weight)
        self.register_buffer("scale_out", scale_out.float())

    def dense_weight(self):
        return self.weight.float() * self.scale_out[:, None]


class Int4Linear(_QuantLinear):
    """Packed int4 codes [out / 2, in] with `scale_out` [out]."""

    def __init__(self, weight, scale_out, bias=None):
        super().__init__(weight.shape[1], 2 * weight.shape[0], bias)
        self.register_buffer("weight", weight)
        self.register_buffer("scale_out", scale_out.float())

    def dense_weight(self):
        return dequantize_int4(self.weight, self.scale_out, torch.float32)


def _all(sl: Optional[slice]) -> slice:
    return slice(None) if sl is None else sl


def linear(mod: nn.Module, x: torch.Tensor, out: Optional[slice] = None,
           in_: Optional[slice] = None, bias: bool = True,
           act: Optional[str] = None, plain: bool = False) -> torch.Tensor:
    """y = x @ W[out, in]^T (+ b[out] when `bias`), then `act`, for an
    nn.Linear or a quantized linear. int8 fuses `act` into the W8A8
    epilogue (on fp32, as the JAX `mlp()` does); the other tiers apply it
    to the output. plain=True runs the W8A8 kernel's plain version on any
    device (a reference for checks on the card)."""
    out, in_ = _all(out), _all(in_)
    b = mod.bias[out] if bias and mod.bias is not None else None
    if isinstance(mod, Int8Linear):
        fn = w8a8_linear_plain if plain else w8a8_linear
        return fn(x, mod.weight[out, in_], mod.scale_out[out], b, act)
    if isinstance(mod, Fp8Linear):
        w = (mod.weight[out, in_].float() * mod.scale).to(x.dtype)
    elif isinstance(mod, Int4Linear):
        w = dequantize_int4(mod.weight, mod.scale_out, x.dtype)[out, in_]
    else:
        w = mod.weight[out, in_]
    y = F.linear(x, w, b.to(x.dtype) if b is not None else None)
    return EPILOGUE_ACTS[act](y) if act is not None else y


def _float_weight(mod: nn.Module) -> torch.Tensor:
    """The weight a tier converter starts from: the stored weight, or the
    dequantized one of a tier already applied (fp32)."""
    return mod.dense_weight() if isinstance(mod, _QuantLinear) else mod.weight


def to_fp8(mod: nn.Module) -> Fp8Linear:
    return Fp8Linear(*quantize_tensor_fp8(_float_weight(mod)), mod.bias)


def to_int8(mod: nn.Module) -> Int8Linear:
    return Int8Linear(*quantize_tensor_int8(_float_weight(mod)), mod.bias)


def to_int4(mod: nn.Module) -> Int4Linear:
    return Int4Linear(*quantize_tensor_int4(_float_weight(mod)), mod.bias)


TIER_OF = {Fp8Linear: to_fp8, Int8Linear: to_int8, Int4Linear: to_int4}


def _is_linear(mod: nn.Module) -> bool:
    return isinstance(mod, (nn.Linear, _QuantLinear))


@torch.no_grad()
def _replace_linears(root: nn.Module, convert, select=lambda name: True):
    """Replace every linear under `root` whose dotted name passes `select`
    by `convert(module)`, one module at a time."""
    for name, mod in list(root.named_modules()):
        if name and _is_linear(mod) and select(name):
            parent_name, _, attr = name.rpartition(".")
            parent = root.get_submodule(parent_name) if parent_name else root
            setattr(parent, attr, convert(mod))


def quantize_stack(root: nn.Module, fp8: bool = False, int8: bool = False,
                   int4_modulation: bool = False) -> nn.Module:
    """The weight tiers on every linear under `root` (a block stack, or one
    block), in place and in the JAX order: fp8, then int8, then int4 of
    the adaLN modulation linears."""
    if fp8:
        _replace_linears(root, to_fp8)
    if int8:
        _replace_linears(root, to_int8)
    if int4_modulation:
        _replace_linears(root, to_int4, lambda name: any(
            f".{k}." in f".{name}" for k in MODULATION_KEYS))
    return root


def quantize_dit(model: nn.Module, fp8: bool = False, int8: bool = False,
                 int4_modulation: bool = False) -> nn.Module:
    """Apply the weight tiers to the block linears of an HYVideoDiT, in
    place and in the JAX order (inference.py:157-164): fp8, then int8,
    then int4 of the adaLN modulation linears."""
    for stack in (model.double_blocks, model.single_blocks):
        quantize_stack(stack, fp8, int8, int4_modulation)
    return model


def quantize_llama_int8(model: nn.Module) -> nn.Module:
    """int8 (per output channel) for every layer linear of a LlamaModel, in
    place (JAX models/text/llama.py:quantize_llama_params_int8); the
    embedding and the RMSNorm scales keep their type."""
    _replace_linears(model.layers, to_int8)
    return model

