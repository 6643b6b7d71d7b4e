"""Plain reference of the t-ops sweep's scores, in float64: PSNR and SSIM
as the reference's evaluation harness defines them (cv2 PSNR per frame, the
mean over the frames whose PSNR is finite; skimage SSIM with a uniform 7x7
window, K1 = 0.01, K2 = 0.03, sample covariance, the valid region, per
channel then per frame), and LPIPS (AlexNet taps, unit-normalized features,
squared differences, 1x1 heads, spatial mean, summed over taps; the
vendored lpips package of evaluation/compute_metrics.py).

Frames: a [1, 3, T, H, W] video in [-1, 1] becomes uint8 [T, H, W, 3] by
truncation of (x + 1) * 127.5 clipped to [0, 255], as the sweep's `.pt`
interchange does; two videos are cut to their common frames and size.

The control's precisions, the nearest below each score's: PSNR and SSIM in
float32 (float64 stated), LPIPS in bfloat16 (the sweep runs it in float32).
Imports nothing of the program.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..weights import LPIPS_ALEX

WIN = 7
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def to_frames(video: torch.Tensor) -> torch.Tensor:
    x = video[0].float().permute(1, 2, 3, 0)
    return ((x + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def common(a: torch.Tensor, b: torch.Tensor):
    t, h, w = (min(x, y) for x, y in zip(a.shape[:3], b.shape[:3]))
    return a[:t, :h, :w], b[:t, :h, :w]


def psnr(a, b, dtype=torch.float64) -> float:
    d = a.to(dtype) - b.to(dtype)
    mse = d.square().reshape(d.shape[0], -1).mean(1)
    v = 10.0 * torch.log10(255.0 ** 2 / mse)
    v = v[torch.isfinite(v)]
    return float(v.mean()) if v.numel() else float("inf")


def ssim(a, b, dtype=torch.float64) -> float:
    x = a.to(dtype).permute(0, 3, 1, 2)
    y = b.to(dtype).permute(0, 3, 1, 2)
    t, c, h, w = x.shape
    x, y = x.reshape(t * c, 1, h, w), y.reshape(t * c, 1, h, w)

    def box(v):
        return F.avg_pool2d(v, WIN, stride=1)

    norm = WIN ** 2 / (WIN ** 2 - 1)
    ux, uy = box(x), box(y)
    vx = norm * (box(x * x) - ux * ux)
    vy = norm * (box(y * y) - uy * uy)
    vxy = norm * (box(x * y) - ux * uy)
    c1, c2 = (0.01 * 255) ** 2, (0.03 * 255) ** 2
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)
         / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)))
    return float(s.reshape(t, c, -1).mean(2).mean(1).mean())


def lpips(sd, a, b, dtype=torch.float64, batch: int = 16) -> float:
    """Mean per-frame LPIPS of uint8 frames, weights `sd` (LPIPS keys)."""
    w = {k: v.to(dtype) for k, v in sd.items()}
    shift = torch.tensor(_SHIFT, dtype=dtype, device=a.device).view(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=dtype, device=a.device).view(1, 3, 1, 1)

    def taps(x):
        x = (x / 127.5 - 1.0 - shift) / scale
        out = []
        for i, (_, _, stride, pad) in enumerate(LPIPS_ALEX):
            x = F.relu(F.conv2d(x, w[f"features.{i}.weight"],
                                w[f"features.{i}.bias"], stride, pad))
            out.append(x)
            if i < 2:
                x = F.max_pool2d(x, 3, 2)
        return out

    def unit(f):
        return f / (f.square().sum(1, keepdim=True).sqrt() + 1e-10)

    vals = []
    for i in range(0, a.shape[0], batch):
        xa = a[i:i + batch].to(dtype).permute(0, 3, 1, 2)
        xb = b[i:i + batch].to(dtype).permute(0, 3, 1, 2)
        total = 0.0
        for j, (fa, fb) in enumerate(zip(taps(xa), taps(xb))):
            total = total + F.conv2d((unit(fa) - unit(fb)) ** 2,
                                     w[f"lins.{j}.weight"]).mean((1, 2, 3))
        vals.append(total)
    return float(torch.cat(vals).mean())


def scores(sd_lpips, orig: torch.Tensor, recon: torch.Tensor,
           control: bool = False) -> dict:
    """{psnr, ssim, lpips} of two [1, 3, T, H, W] videos in [-1, 1], in
    float64, or (`control`) in the control's precisions."""
    a, b = common(to_frames(orig), to_frames(recon))
    dt, lp_dt = ((torch.float32, torch.bfloat16) if control
                 else (torch.float64, torch.float64))
    return {"psnr": psnr(a, b, dt), "ssim": ssim(a, b, dt),
            "lpips": lpips(sd_lpips, a, b, lp_dt)}
