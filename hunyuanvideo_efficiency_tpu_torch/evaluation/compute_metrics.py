"""Batch metric computation over reconstruction directories (JAX
counterpart: evaluation/compute_metrics.py).

Mirror of the reference's evaluation harness (reference:
evaluation/compute_metrics.py:18-161 serial, compute_metrics_threads.py:
20-260 threaded over exp_* subdirs): pairs original/reconstructed videos
by filename, computes PSNR/SSIM (+ LPIPS when a model is given) on the
metric device, writes a timestamped metrics_<ts>.txt.

Videos may be .mp4 (decoded with OpenCV, imported only for them) or .pt
tensors ([C, T, H, W] in [-1, 1], the experiment harness interchange
format). Frames load on the CPU as uint8 and move to `device` to be scored.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .metrics import psnr_video, ssim_video


def load_video_frames(path: str, max_frames: Optional[int] = None
                      ) -> torch.Tensor:
    """-> [T, H, W, C] uint8 on the CPU. A `.pt` tensor in [-1, 1] maps to
    uint8 by truncation, ((x + 1) * 127.5) clipped to [0, 255] and cast, as
    the JAX package does."""
    if path.endswith(".pt"):
        t = torch.load(path, map_location="cpu", weights_only=True).float()
        if t.ndim == 5:
            t = t[0]
        t = t.permute(1, 2, 3, 0)  # [T, H, W, C]
        t = ((t + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)
        return t[:max_frames] if max_frames else t
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading {path} needs OpenCV (cv2); .pt tensors "
                          f"load without it") from e

    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(f, cv2.COLOR_BGR2RGB))
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"No frames decoded from {path}")
    return torch.from_numpy(np.stack(frames))


@dataclass
class PairMetrics:
    name: str
    psnr: float
    ssim: float
    lpips: Optional[float] = None


@dataclass
class DirMetrics:
    pairs: List[PairMetrics] = field(default_factory=list)

    @property
    def mean_psnr(self):
        return float(np.mean([p.psnr for p in self.pairs]))

    @property
    def mean_ssim(self):
        return float(np.mean([p.ssim for p in self.pairs]))

    @property
    def mean_lpips(self):
        vals = [p.lpips for p in self.pairs if p.lpips is not None]
        return float(np.mean(vals)) if vals else None


def _match_pairs(orig_dir: str, recon_dir: str) -> List[Tuple[str, str, str]]:
    exts = (".mp4", ".pt")

    def stem_map(d):
        return {os.path.splitext(f)[0]: os.path.join(d, f)
                for f in sorted(os.listdir(d)) if f.endswith(exts)}

    o, r = stem_map(orig_dir), stem_map(recon_dir)
    return [(k, o[k], r[k]) for k in sorted(o) if k in r]


def compute_pair(name: str, orig_path: str, recon_path: str,
                 lpips_params=None, max_frames: Optional[int] = None,
                 device="cuda") -> PairMetrics:
    """Both videos cropped to their common frames and size, scored on
    `device` (LPIPS on its module's device)."""
    a = load_video_frames(orig_path, max_frames)
    b = load_video_frames(recon_path, max_frames)
    t = min(len(a), len(b))
    h = min(a.shape[1], b.shape[1])
    w = min(a.shape[2], b.shape[2])
    a, b = a[:t, :h, :w].to(device), b[:t, :h, :w].to(device)
    m = PairMetrics(name, psnr_video(a, b), ssim_video(a, b))
    if lpips_params is not None:
        from .lpips import lpips_video

        m.lpips = lpips_video(lpips_params, a, b)
    return m


def compute_metrics_dir(orig_dir: str, recon_dir: str,
                        lpips_params=None, max_frames: Optional[int] = None,
                        num_workers: int = 1,
                        out_txt: Optional[str] = None,
                        device="cuda") -> DirMetrics:
    pairs = _match_pairs(orig_dir, recon_dir)
    if not pairs:
        raise ValueError(
            f"No matching video pairs between {orig_dir} and {recon_dir}")

    def one(p):
        return compute_pair(p[0], p[1], p[2], lpips_params, max_frames,
                            device)

    if num_workers > 1:
        with ThreadPoolExecutor(num_workers) as ex:
            results = list(ex.map(one, pairs))
    else:
        results = [one(p) for p in pairs]
    dm = DirMetrics(results)

    if out_txt is None:
        ts = time.strftime("%Y-%m-%d")
        out_txt = os.path.join(recon_dir, f"metrics_{ts}.txt")
    with open(out_txt, "w") as f:
        # same layout as the reference results file
        # (evaluation/results/metrics_2025-01-20.txt: mean psnr/ssim/lpips)
        f.write(f"Average PSNR: {dm.mean_psnr:.6f}\n")
        f.write(f"Average SSIM: {dm.mean_ssim:.6f}\n")
        if dm.mean_lpips is not None:
            f.write(f"Average LPIPS: {dm.mean_lpips:.6f}\n")
        f.write("\n")
        for p in results:
            line = f"{p.name}: psnr={p.psnr:.4f} ssim={p.ssim:.4f}"
            if p.lpips is not None:
                line += f" lpips={p.lpips:.4f}"
            f.write(line + "\n")
    return dm


def compute_metrics_experiments(orig_dir: str, exp_base: str,
                                lpips_params=None, num_workers: int = 4,
                                device="cuda") -> Dict[str, DirMetrics]:
    """Threaded sweep over exp_* subdirectories
    (reference: compute_metrics_threads.py:125-197)."""
    results = {}
    subdirs = sorted(d for d in os.listdir(exp_base)
                     if d.startswith("exp_")
                     and os.path.isdir(os.path.join(exp_base, d)))

    def one(d):
        return d, compute_metrics_dir(orig_dir, os.path.join(exp_base, d),
                                      lpips_params, device=device)

    with ThreadPoolExecutor(num_workers) as ex:
        for d, dm in ex.map(one, subdirs):
            results[d] = dm
    return results
