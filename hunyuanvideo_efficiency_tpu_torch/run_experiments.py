"""Experiment sweep entry (JAX counterpart: the root run_experiments.py,
which replaces run_experiments_{pool,stride,buckets}.sh): generate configs
-> per-config VAE round trip -> metrics -> ranking.

    python -m hunyuanvideo_efficiency_tpu_torch.run_experiments \
        --tensor-dir IN --orig-dir ORIG --out-base OUT [--mode stride] \
        [--cap N] [--random-init] [--rank-by psnr] [--device cpu]

Writes OUT/configs/exp_N.json, OUT/exp_N/ (reconstructions and the metrics
report) and OUT/ranking_<key>.json. Runs on the card unless `--device cpu`
is passed.
"""
import argparse
import json
import logging

from .experiments import rank_results, run_sweep

logger = logging.getLogger("hyvideo")


def main(argv=None):
    """Runs the entry on `argv` (default: sys.argv); returns the ranking
    table."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description="t-ops experiment sweep")
    p.add_argument("--tensor-dir", required=True,
                   help=".pt input tensors (mp42tensor output)")
    p.add_argument("--orig-dir", required=True,
                   help="ground-truth videos (mp4 or .pt) for metrics")
    p.add_argument("--out-base", required=True)
    p.add_argument("--mode", default="pool",
                   choices=["pool", "stride", "stride2"])
    p.add_argument("--cap", type=int, default=384)
    p.add_argument("--vae-path", default="ckpts/hunyuan-video-t2v-720p/vae")
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--rank-by", default="psnr",
                   choices=["psnr", "ssim", "lpips"])
    p.add_argument("--device", type=str, default="cuda")
    a = p.parse_args(argv)

    results = run_sweep(a.tensor_dir, a.orig_dir, a.out_base, mode=a.mode,
                        cap=a.cap, vae_path=a.vae_path,
                        max_files=a.max_files, random_init=a.random_init,
                        logger=logger, device=a.device)
    ranked = rank_results(results, a.rank_by)
    table = [{"name": r.name, "psnr": r.metrics.mean_psnr,
              "ssim": r.metrics.mean_ssim, "lpips": r.metrics.mean_lpips,
              "seconds": r.seconds} for r in ranked]
    out = f"{a.out_base}/ranking_{a.rank_by}.json"
    with open(out, "w") as f:
        json.dump(table, f, indent=2)
    logger.info(f"Ranking written to {out}")
    for row in table[:10]:
        logger.info(row)
    return table


if __name__ == "__main__":
    main()
