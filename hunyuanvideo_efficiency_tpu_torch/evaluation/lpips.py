"""LPIPS with the AlexNet backbone, an `nn.Module` (JAX counterpart:
evaluation/lpips.py).

Re-implements the reference's vendored LPIPS (reference:
rebuttal/common_metrics_on_video_quality/lpips/lpips.py, used by
evaluation/compute_metrics.py:43-62): input scaling layer, AlexNet conv
stack with 5 ReLU taps, per-channel unit normalization, squared difference,
1x1 linear heads, spatial mean, sum over taps. The convs are F.conv2d and
F.max_pool2d on the module's device, in fp32.

Weights are not bundled. `convert_lpips_weights` turns the torchvision
AlexNet + lpips `lin` state dicts into this module's state dict,
`load_lpips_params` reads the JAX package's converted `.npz`, and
`random_lpips_params` draws random weights for tests and smoke runs.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# LPIPS ScalingLayer constants (reference lpips/lpips.py ScalingLayer)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet feature geometry: (out_ch, kernel, stride, pad), maxpool after idx
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}
# conv layer indices in torchvision's AlexNet `features`
_TORCHVISION_IDX = (0, 3, 6, 8, 10)


class LPIPS(nn.Module):
    """Keys `features.{i}.weight|bias` (the five convs) and
    `lins.{i}.weight` ([1, C, 1, 1] heads)."""

    def __init__(self, device=None, dtype=torch.float32):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        cins = [3] + [c for c, *_ in _ALEX[:-1]]
        self.features = nn.ModuleList(
            nn.Conv2d(cin, cout, k, s, p, **fk)
            for cin, (cout, k, s, p) in zip(cins, _ALEX))
        self.lins = nn.ModuleList(nn.Conv2d(cout, 1, 1, bias=False, **fk)
                                  for cout, *_ in _ALEX)
        self.register_buffer("shift", torch.tensor(_SHIFT, **fk).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE, **fk).reshape(
            1, 3, 1, 1), persistent=False)

    def taps(self, x: torch.Tensor):
        """x [B, 3, H, W] in [-1, 1] -> the 5 ReLU taps."""
        x = (x - self.shift) / self.scale
        out = []
        for i, conv in enumerate(self.features):
            x = F.relu(conv(x))
            out.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return out

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b [B, 3, H, W] in [-1, 1] -> [B] LPIPS distances."""
        total = 0.0
        for lin, xa, xb in zip(self.lins, self.taps(a), self.taps(b)):
            d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
            total = total + lin(d).mean(dim=(1, 2, 3))
        return total


def _unit_normalize(f, eps=1e-10):
    return f / (f.square().sum(dim=1, keepdim=True).sqrt() + eps)


def lpips_pair(model: LPIPS, a: torch.Tensor, b: torch.Tensor
               ) -> torch.Tensor:
    """a/b [B, 3, H, W] in [-1, 1] -> [B] LPIPS distances."""
    return model(a, b)


def lpips_video(model: LPIPS, a, b, batch: int = 8) -> float:
    """[T, H, W, C] uint8/float videos -> mean per-frame LPIPS on the
    model's device (reference: compute_metrics.py:43-62 batches frames on
    one device)."""
    dev = model.lins[0].weight.device
    a = torch.as_tensor(a).to(dev, torch.float32)
    b = torch.as_tensor(b).to(dev, torch.float32)
    if a.max() > 1.5:
        a, b = a / 127.5 - 1.0, b / 127.5 - 1.0
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    vals = [model(a[i:i + batch], b[i:i + batch])
            for i in range(0, a.shape[0], batch)]
    return float(torch.cat(vals).mean())


def convert_lpips_weights(alexnet_sd: Dict[str, np.ndarray],
                          lin_sd: Dict[str, np.ndarray]
                          ) -> Dict[str, torch.Tensor]:
    """torchvision `alexnet().features` state dict + lpips `lin` state dict
    -> LPIPS state dict (torch layouts, so the kernels keep their shape)."""
    sd = {}
    for i, j in enumerate(_TORCHVISION_IDX):
        sd[f"features.{i}.weight"] = torch.as_tensor(
            np.asarray(alexnet_sd[f"features.{j}.weight"]), dtype=torch.float32)
        sd[f"features.{i}.bias"] = torch.as_tensor(
            np.asarray(alexnet_sd[f"features.{j}.bias"]), dtype=torch.float32)
    for i in range(len(_ALEX)):
        key = f"lin{i}.model.1.weight"
        if key not in lin_sd:
            key = f"lins.{i}.model.1.weight"
        sd[f"lins.{i}.weight"] = torch.as_tensor(np.asarray(lin_sd[key]),
                                                 dtype=torch.float32)
    return sd


def lpips_from_state_dict(sd: Dict[str, torch.Tensor], device="cuda"
                          ) -> LPIPS:
    model = LPIPS(device=device)
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False)


def load_lpips_params(path: str, device="cuda") -> LPIPS:
    """The JAX package's converted LPIPS `.npz` (its save_params_npz of
    convert_lpips_weights) as an LPIPS module on `device`."""
    from ..utils.checkpoint import load_params_npz
    from ..utils.weights import lpips_state_dict_from_jax

    return lpips_from_state_dict(
        lpips_state_dict_from_jax(load_params_npz(path)), device)


def random_lpips_params(generator: Optional[torch.Generator] = None,
                        device=None) -> LPIPS:
    """Random-weight LPIPS, drawn as the JAX package draws it (conv weights
    N(0, 0.1^2), zero biases, |N(0, 0.01^2)| heads) from `generator` (seed
    0 on `device` when None): for tests and smoke runs, where relative
    comparisons still go through a perceptual stack of the right structure.
    The module lies on `device`, else on the generator's device, else on
    the card."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    model = LPIPS(device=device)
    with torch.no_grad():
        for conv in model.features:
            conv.weight.normal_(0.0, 0.1, generator=generator)
            conv.bias.zero_()
        for lin in model.lins:
            lin.weight.normal_(0.0, 0.01, generator=generator).abs_()
    return model.eval().requires_grad_(False)
