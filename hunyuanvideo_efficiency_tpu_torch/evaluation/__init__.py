"""Quality metrics: PSNR/SSIM/MS-SSIM (torch float64 on the frames'
device), LPIPS (AlexNet nn.Module), FVD (TorchScript I3D), FVMD, batch
harnesses (JAX counterpart: evaluation/; reference: evaluation/,
rebuttal/common_metrics_on_video_quality/)."""
from .compute_metrics import (DirMetrics, PairMetrics, compute_metrics_dir,
                              compute_metrics_experiments, compute_pair,
                              load_video_frames)
from .fvd import compute_fvd, i3d_features
from .fvmd import calc_hist, fvmd, track_keypoints, video_motion_features
from .lpips import (LPIPS, convert_lpips_weights, load_lpips_params,
                    lpips_pair, lpips_video, random_lpips_params)
from .metrics import (frechet_distance, gaussian_stats, ms_ssim,
                      ms_ssim_video, psnr, psnr_video, ssim, ssim_video)
from .run_metrics import demo, per_video_metrics

__all__ = [
    "DirMetrics", "PairMetrics", "compute_metrics_dir",
    "compute_metrics_experiments", "compute_pair", "load_video_frames",
    "compute_fvd", "i3d_features", "convert_lpips_weights",
    "load_lpips_params", "lpips_pair", "lpips_video", "random_lpips_params",
    "frechet_distance", "gaussian_stats", "psnr", "psnr_video", "ssim",
    "ssim_video", "ms_ssim", "ms_ssim_video", "demo", "per_video_metrics",
    "calc_hist", "fvmd", "track_keypoints", "video_motion_features", "LPIPS",
]
