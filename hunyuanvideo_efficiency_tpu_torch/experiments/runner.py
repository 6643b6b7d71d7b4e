"""Experiment sweep runner (JAX counterpart: experiments/runner.py).

Replaces the reference's shell GPU-farm schedulers
(reference: run_experiments_pool.sh round-robin over CUDA_VISIBLE_DEVICES,
run_experiments_stride.sh serial infer+metrics, run_experiments_buckets.sh
symlinked metric buckets): one process runs each experiment config through
the VAE round trip of the port's `infer` entry on one device and scores it
there, optionally bucketed by bitrate.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..evaluation.compute_metrics import DirMetrics, compute_metrics_dir
from .enumeration import write_configs


@dataclass
class ExperimentResult:
    name: str
    config_path: str
    metrics: Optional[DirMetrics]
    seconds: float


def run_experiment(config_path: str, tensor_dir: str, output_dir: str,
                   vae_path: str = "ckpts/hunyuan-video-t2v-720p/vae",
                   max_files: Optional[int] = None, mp4: bool = False,
                   random_init: bool = False, logger=None,
                   device="cuda") -> float:
    """One `infer` run (fp16 VAE, the config applied) on `device`; returns
    wall seconds. mp4 output needs OpenCV, which the card's machine lacks,
    so it is off by default."""
    from .. import infer
    from ..data.dataset_loader import VideoTensorDataset

    t0 = time.time()
    vae, _, _, _ = infer.load_vae(
        "884-16c-hy", "fp16", vae_path, t_ops_config_path=config_path,
        test=True, random_init=random_init, logger=logger, device=device)
    infer.infer_vae(vae, VideoTensorDataset(tensor_dir), output_dir,
                    max_files=max_files, mp4=mp4)
    return time.time() - t0


def run_sweep(tensor_dir: str, orig_video_dir: str, out_base: str,
              mode: str = "pool", cap: int = 384,
              vae_path: str = "ckpts/hunyuan-video-t2v-720p/vae",
              max_files: Optional[int] = None, random_init: bool = False,
              compute_metrics: bool = True, lpips_params=None,
              logger=None, device="cuda") -> List[ExperimentResult]:
    """Generate the `mode` configs, then run and score each on `device`
    (reference: run_experiments_stride.sh per-config infer + metrics)."""
    config_dir = os.path.join(out_base, "configs")
    results: List[ExperimentResult] = []
    for cfg_path in write_configs(config_dir, mode, cap):
        name = os.path.splitext(os.path.basename(cfg_path))[0]
        out_dir = os.path.join(out_base, name)
        secs = run_experiment(cfg_path, tensor_dir, out_dir, vae_path,
                              max_files=max_files, random_init=random_init,
                              logger=logger, device=device)
        metrics = None
        if compute_metrics:
            metrics = compute_metrics_dir(orig_video_dir, out_dir,
                                          lpips_params=lpips_params,
                                          device=device)
        results.append(ExperimentResult(name, cfg_path, metrics, secs))
        if logger:
            msg = f"{name}: {secs:.1f}s"
            if metrics:
                msg += (f" psnr={metrics.mean_psnr:.3f}"
                        f" ssim={metrics.mean_ssim:.4f}")
            logger.info(msg)
    return results


def rank_results(results: List[ExperimentResult],
                 key: str = "psnr") -> List[ExperimentResult]:
    """Rank experiments by a metric (reference: analysis.ipynb pandas
    ranking). Higher is better for psnr/ssim, lower for lpips."""
    scored = [r for r in results if r.metrics is not None]
    if key == "lpips":
        return sorted(scored, key=lambda r: (r.metrics.mean_lpips
                                             if r.metrics.mean_lpips
                                             is not None else np.inf))
    return sorted(scored, key=lambda r: -getattr(r.metrics, f"mean_{key}"))


def bucket_tensors(bitrate_txt: str, tensor_dir: str, bucket_dir: str,
                   edges_kbps: List[float]) -> Dict[str, List[str]]:
    """Bitrate-bucketed symlink trees
    (reference: run_experiments_buckets.sh symlinks .pt subsets per bucket)."""
    with open(bitrate_txt) as f:
        rates = {ln.split()[0]: float(ln.split()[1])
                 for ln in f if ln.strip()}
    buckets: Dict[str, List[str]] = {}
    edges = [0.0] + [e * 1000 for e in edges_kbps] + [float("inf")]
    for name, rate in rates.items():
        stem = os.path.splitext(name)[0]
        pt = os.path.join(tensor_dir, stem + ".pt")
        if not os.path.exists(pt):
            continue
        for lo, hi in zip(edges[:-1], edges[1:]):
            if lo <= rate < hi:
                label = f"bucket_{int(lo/1000)}_{int(hi/1000) if hi != float('inf') else 'inf'}"
                bdir = os.path.join(bucket_dir, label)
                os.makedirs(bdir, exist_ok=True)
                link = os.path.join(bdir, stem + ".pt")
                if not os.path.exists(link):
                    os.symlink(os.path.abspath(pt), link)
                buckets.setdefault(label, []).append(stem)
                break
    return buckets
