"""Video quality metrics: PSNR / SSIM / MS-SSIM as torch ops in float64 on
the frames' device, and the Frechet distance on the host (JAX counterpart:
evaluation/metrics.py).

Re-implements the reference's metric definitions without its external deps
(reference: evaluation/compute_metrics.py:31-41 uses cv2 PSNR + skimage
SSIM; rebuttal/common_metrics_on_video_quality/calculate_{psnr,ssim}.py):

* PSNR: 10*log10(data_range^2 / MSE), per frame, averaged over the frames
  whose PSNR is finite (identical frames give inf and are left out).
* SSIM: Wang et al. 2004 with the skimage defaults the reference relies on:
  uniform 7x7 window, K1=0.01, K2=0.03, per channel then averaged, sample
  covariance normalization (N-1). Only the valid region is kept, where
  scipy's `uniform_filter` never reaches the frame's edge, so the filter is
  a 7x7 `avg_pool2d` without padding.

The JAX package threads these over uint8 frames in host C++
(native/metrics_core.cpp); here every frame and channel of a video is one
batch of float64 ops on the device the frames lie on, the card in the
experiment harness. Frames are [..., H, W, C] tensors (or arrays, taken on
the CPU), uint8 or float in [0, data_range].
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

WIN = 7
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _f64(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.float64)


def _same_shape(a, b) -> None:
    if tuple(a.shape) != tuple(b.shape):
        raise ValueError(f"videos differ in shape: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")


def _frame_psnr(a, b, data_range: float) -> torch.Tensor:
    """[T, ...] -> [T] PSNR per frame (inf where a frame is identical)."""
    d = _f64(a) - _f64(b)
    mse = d.square().reshape(d.shape[0], -1).mean(dim=1)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def psnr(a, b, data_range: float = 255.0) -> float:
    """One frame [..., H, W, C]."""
    return float(_frame_psnr(_f64(a)[None], _f64(b)[None], data_range)[0])


def psnr_video(a, b, data_range: float = 255.0) -> float:
    """[T, H, W, C]: per-frame PSNR averaged over the finite ones
    (reference computes per frame, calculate_psnr.py:6-15)."""
    _same_shape(a, b)
    vals = _frame_psnr(a, b, data_range)
    finite = vals[torch.isfinite(vals)]
    return float(finite.mean()) if finite.numel() else float("inf")


def _box(x: torch.Tensor) -> torch.Tensor:
    """Mean over each 7x7 window of [N, H, W], valid region only (empty
    where a side is under 7, so that its mean is nan as in numpy)."""
    n, h, w = x.shape
    if h < WIN or w < WIN:
        return x.new_empty(n, max(h - WIN + 1, 0), max(w - WIN + 1, 0))
    return F.avg_pool2d(x[:, None], WIN, stride=1)[:, 0]


def _ssim_maps(x: torch.Tensor, y: torch.Tensor, data_range: float,
               k1: float = 0.01, k2: float = 0.03
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSIM and contrast-structure maps [N, H-6, W-6] of [N, H, W] float64
    planes."""
    cov_norm = WIN ** 2 / (WIN ** 2 - 1)
    ux, uy = _box(x), _box(y)
    vx = cov_norm * (_box(x * x) - ux * ux)
    vy = cov_norm * (_box(y * y) - uy * uy)
    vxy = cov_norm * (_box(x * y) - ux * uy)
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    cs = (2 * vxy + c2) / (vx + vy + c2)
    s = ((2 * ux * uy + c1) / (ux ** 2 + uy ** 2 + c1)) * cs
    return s, cs


def _planes(a) -> torch.Tensor:
    """[T, H, W, C] or [H, W, C] or [H, W] -> float64 [T, C, H, W]."""
    x = _f64(a)
    if x.ndim == 2:
        x = x[..., None]
    if x.ndim == 3:
        x = x[None]
    return x.permute(0, 3, 1, 2)


def _frame_ssim(a, b, data_range: float) -> torch.Tensor:
    """-> [T] channel-averaged SSIM per frame."""
    x, y = _planes(a), _planes(b)
    t, c, h, w = x.shape
    s, _ = _ssim_maps(x.reshape(t * c, h, w), y.reshape(t * c, h, w),
                      data_range)
    return s.reshape(t, c, -1).mean(dim=2).mean(dim=1)


def ssim(a, b, data_range: float = 255.0) -> float:
    """[H, W, C] or [H, W]: channel-averaged SSIM."""
    return float(_frame_ssim(a, b, data_range)[0])


def ssim_video(a, b, data_range: float = 255.0) -> float:
    """[T, H, W, C]: per-frame SSIM averaged."""
    _same_shape(a, b)
    return float(_frame_ssim(a, b, data_range).mean())


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    """2x average-pool of [N, H, W], cropping odd edges."""
    h, w = x.shape[-2:]
    x = x[..., : h - h % 2, : w - w % 2]
    return (x[..., 0::2, 0::2] + x[..., 1::2, 0::2] + x[..., 0::2, 1::2]
            + x[..., 1::2, 1::2]) / 4.0


def _frame_ms_ssim(a, b, data_range: float, weights) -> torch.Tensor:
    """-> [T] channel-averaged MS-SSIM per frame (Wang 2003)."""
    x, y = _planes(a), _planes(b)
    t, c, h, w = x.shape
    x, y = x.reshape(t * c, h, w), y.reshape(t * c, h, w)
    val = torch.ones(t * c, dtype=torch.float64, device=x.device)
    for i, wt in enumerate(weights):
        s, cs = _ssim_maps(x, y, data_range)
        m = (s if i == len(weights) - 1 else cs).reshape(t * c, -1).mean(1)
        val = val * m.clamp(min=0) ** wt
        x, y = _downsample2(x), _downsample2(y)
    return val.reshape(t, c).mean(dim=1)


def ms_ssim(a, b, data_range: float = 255.0,
            weights=_MSSSIM_WEIGHTS) -> float:
    """Multi-scale SSIM, channel-averaged (reference: rebuttal run.py uses
    pytorch-msssim)."""
    return float(_frame_ms_ssim(a, b, data_range, weights)[0])


def ms_ssim_video(a, b, data_range: float = 255.0) -> float:
    return float(_frame_ms_ssim(a, b, data_range, _MSSSIM_WEIGHTS).mean())


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (FVD/FID core, reference:
    rebuttal/common_metrics_on_video_quality/fvd/*/fvd.py); scipy's sqrtm on
    the host, as in the JAX package."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1 @ sigma2, disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean, _ = linalg.sqrtm(
            (sigma1 + offset) @ (sigma2 + offset), disp=False)
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def gaussian_stats(features) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] feature matrix (array or tensor) -> (mu, sigma) on the
    host."""
    features = np.asarray(torch.as_tensor(features).cpu())
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)
