"""The one traffic generator: it reads a traffic file
(`benchmark/traffic/<name>.json`) and draws the run's inputs from
`--seed`. Every seed gets the same sizes (word counts, frames, videos);
only the values differ.

`smooth_video` is a frozen copy of chip_smoke.py:harness_video (the t-ops
sweep's seeded videos) with the sizes taken from the traffic file.
Imports nothing of the program.
"""
from __future__ import annotations

import json
import random
import string
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((ROOT / "traffic" / f"{name}.json").read_text())


def prompt(seed: int, words: int, letters) -> str:
    """`words` lowercase words of letters[0]..letters[1] letters."""
    rng = random.Random(seed)
    lo, hi = letters
    return " ".join("".join(rng.choice(string.ascii_lowercase)
                            for _ in range(rng.randint(lo, hi)))
                    for _ in range(words))


def smooth_video(g: torch.Generator, frames: int, height: int, width: int,
                 low_grid) -> torch.Tensor:
    """A smooth video [1, 3, F, H, W] in [-1, 1] drawn from `g` on its
    device: low-frequency noise upsampled trilinearly, so that frames have
    structure for SSIM to see."""
    low = torch.randn(1, 3, *low_grid, generator=g, device=g.device)
    v = torch.nn.functional.interpolate(
        low, size=(frames, height, width), mode="trilinear",
        align_corners=False)
    return torch.tanh(v)
