"""Metric computation entry (JAX counterpart: the root compute_metrics.py;
reference: evaluation/compute_metrics.py:18-161 serial and
compute_metrics_threads.py:20-260 threaded over exp_* dirs).

    python -m hunyuanvideo_efficiency_tpu_torch.compute_metrics \
        --orig-dir ORIG --recon-dir RECON [--experiments] \
        [--lpips-weights lpips.npz] [--device cpu]

Pairs original/reconstructed videos by filename (mp4, which needs OpenCV,
or .pt), computes PSNR/SSIM (+ LPIPS from the JAX package's converted
weights) on the card unless `--device cpu` is passed, and writes a
timestamped metrics_<ts>.txt per directory.
"""
import argparse
import logging

from .evaluation import (compute_metrics_dir, compute_metrics_experiments,
                         load_lpips_params)

logger = logging.getLogger("hyvideo")


def main(argv=None):
    """Runs the entry on `argv` (default: sys.argv); returns the
    DirMetrics, or {exp_name: DirMetrics} with --experiments."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="Video quality metrics")
    p.add_argument("--orig-dir", required=True)
    p.add_argument("--recon-dir", required=True,
                   help="reconstruction dir, or a base containing exp_* dirs")
    p.add_argument("--experiments", action="store_true",
                   help="treat --recon-dir as a base of exp_* subdirs "
                        "(threaded, like compute_metrics_threads.py)")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--lpips-weights", type=str, default=None,
                   help=".npz from convert_lpips_weights")
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)

    lpips_params = None
    if a.lpips_weights:
        lpips_params = load_lpips_params(a.lpips_weights, a.device)

    if a.experiments:
        results = compute_metrics_experiments(
            a.orig_dir, a.recon_dir, lpips_params=lpips_params,
            num_workers=a.num_workers, device=a.device)
        for name, dm in sorted(results.items()):
            lp = (f" lpips={dm.mean_lpips:.4f}"
                  if dm.mean_lpips is not None else "")
            logger.info(f"{name}: psnr={dm.mean_psnr:.3f} "
                        f"ssim={dm.mean_ssim:.4f}{lp}")
        return results
    dm = compute_metrics_dir(a.orig_dir, a.recon_dir,
                             lpips_params=lpips_params,
                             max_frames=a.max_frames,
                             num_workers=a.num_workers, device=a.device)
    lp = f" lpips={dm.mean_lpips:.4f}" if dm.mean_lpips is not None else ""
    logger.info(f"Average: psnr={dm.mean_psnr:.3f} ssim={dm.mean_ssim:.4f}"
                f"{lp} ({len(dm.pairs)} pairs)")
    return dm


if __name__ == "__main__":
    main()
