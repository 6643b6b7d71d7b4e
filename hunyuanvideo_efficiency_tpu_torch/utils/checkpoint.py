"""Reading reference checkpoints (JAX counterpart: utils/checkpoint.py).

The port's modules carry the reference state-dict names, so a reference
`.pt` loads with `load_state_dict` unchanged. The reference's fp8 DiT ships
E4M3 weights with a side-car `<checkpoint stem>_map.pt` of one scale per
quantized linear (reference: hyvideo/modules/fp8_optimization.py:85-90);
`load_fp8_dit_checkpoint` reads both.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import torch


def load_torch_state_dict(path, load_key: str = "module",
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state dict: bare, under `load_key` (the
    deepspeed `module`/`ema` forms) or under `state_dict`, with an optional
    key prefix stripped (reference: hyvideo/inference.py:279-354,
    hyvideo/vae/__init__.py:94-102)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and load_key in sd:
        sd = sd[load_key]
    elif isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if prefix and any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    return sd


def fp8_map_path(dit_path) -> Path:
    """The scale side-car of an fp8 DiT checkpoint: `<stem>_map.pt`."""
    dit_path = Path(dit_path)
    return dit_path.with_name(dit_path.stem + "_map.pt")


def load_fp8_dit_checkpoint(ckpt_path, map_path, cfg,
                            load_key: str = "module", device="cuda",
                            dtype=torch.bfloat16):
    """An HYVideoDiT from a reference fp8 checkpoint and its scale map (JAX
    utils/checkpoint.py:215-239): the fp8 weights are upcast and multiplied
    by their side-car scales in fp32, the model is loaded through `dtype`,
    and the block linears are re-quantized to the per-tensor fp8 tier."""
    from ..models.dit import build_dit
    from ..ops.quantization import quantize_dit

    sd = load_torch_state_dict(ckpt_path, load_key)
    for name, scale in load_torch_state_dict(map_path).items():
        key = name if name in sd else name.replace(".scale", ".weight")
        if key in sd:
            sd[key] = sd[key].float() * torch.as_tensor(scale).float()
    model = build_dit(cfg, device, dtype)
    model.load_state_dict(sd)
    return quantize_dit(model, fp8=True)
