"""Seeded inputs and weights for checks of the port at full width:
attention operands as the DiT hands them to its kernels, and random
modulation layers for a randomly initialized DiT. `chip_smoke.py` and
`scripts/torch_sp_nccl.py` draw from here, so both check the same inputs.
"""
from __future__ import annotations

import math
import types

import torch

from ..models import dit as dit_mod
from ..models.dit_config import DiTConfig
from ..ops import quantization


def rms_normed(g: torch.Generator, dev, *shape,
               dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of unit RMS, as after the DiT's QK-norm with unit scales."""
    x = torch.randn(*shape, generator=g, device=dev)
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).to(dtype)


def analytic_bound(dev, b: int, h: int, d: int = 128) -> torch.Tensor:
    """C [B, H]: the DiT's analytic score bound with unit RMSNorm scales."""
    norm = dit_mod.RMSNorm(d, device=dev, dtype=torch.bfloat16)
    c = dit_mod._analytic_score_bound(DiTConfig(), d, [(norm, norm)])
    return c.expand(b, h).contiguous()


def joint_inputs(dev, seed: int, n_img: int, b: int = 2, h: int = 24,
                 d: int = 128, lt: int = 256, txt_valid: int = 40,
                 dtype=torch.bfloat16):
    """One joint attention's operands: RMS-normalized q/k and random v for
    `n_img` image and `lt` text tokens, of which the first `txt_valid` are
    valid. Returns ((img q, k, v), (txt q, k, v), the text key bias
    [B, 1, 1, Lt], C [B, H])."""
    g = torch.Generator(dev).manual_seed(seed)

    def qkv(n):
        return (rms_normed(g, dev, b, n, h, d, dtype=dtype),
                rms_normed(g, dev, b, n, h, d, dtype=dtype),
                torch.randn(b, n, h, d, generator=g, device=dev).to(dtype))

    img, txt = qkv(n_img), qkv(lt)
    tb = torch.zeros(b, 1, 1, lt, device=dev)
    tb[..., txt_valid:] = -1e30
    return img, txt, tb, analytic_bound(dev, b, h, d)


def randomize_modulation(model: torch.nn.Module, seed: int) -> None:
    """init_weights zero-inits the adaLN and final layers (every block is
    then the identity): give them N(0, 0.25/fan_in) values, re-quantized in
    the tier a layer holds."""
    g = torch.Generator(model.img_in.proj.weight.device).manual_seed(seed)
    for name, mod in model.named_modules():
        randomize_module(name, mod, g)


@torch.no_grad()
def randomize_module(name: str, mod: torch.nn.Module,
                     g: torch.Generator) -> None:
    """randomize_modulation's draw for the one module `mod` of dotted name
    `name` (a no-op unless it is an adaLN or final linear): called in the
    model's module order with one generator, the same values (the
    weight-sharded DiT's build draws them a chunk at a time)."""
    if hasattr(mod, "in_features") and (
            name.endswith("mod.linear")
            or name.endswith("modulation.linear")
            or "adaLN_modulation" in name
            or name.startswith("final_layer")):
        w = torch.empty(mod.out_features, mod.in_features,
                        device=g.device).normal_(
            0.0, 0.5 / math.sqrt(mod.in_features), generator=g)
        if isinstance(mod, torch.nn.Linear):
            mod.weight.copy_(w)
        else:   # a weight tier: its own converter, same buffers
            tier = quantization.TIER_OF[type(mod)]
            mod.load_state_dict(tier(types.SimpleNamespace(
                weight=w, bias=mod.bias)).state_dict())
