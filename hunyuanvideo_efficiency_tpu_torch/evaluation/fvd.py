"""FVD (Frechet Video Distance) with an I3D feature extractor (JAX
counterpart: evaluation/fvd.py).

Mirror of the reference's offline FVD suite (reference:
rebuttal/common_metrics_on_video_quality/fvd/styleganv/fvd.py and
fvd/videogpt/fvd.py): videos -> I3D logits/features -> Gaussian stats ->
Frechet distance. The I3D weights are the TorchScript file the reference
downloads (`i3d_torchscript.pt`); pass a local path. The I3D runs on the
given device; frames are resized there by bilinear interpolation (the JAX
package uses cv2.INTER_LINEAR, which the card's machine lacks).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import frechet_distance, gaussian_stats


def _resize_video(video: torch.Tensor, size: int = 224) -> torch.Tensor:
    """[..., T, H, W, C] float in [0, 1] -> bilinear-resized
    [..., T, size, size, C] (half-pixel centres, no antialiasing, as
    cv2.INTER_LINEAR)."""
    lead = video.shape[:-3]
    h, w, c = video.shape[-3:]
    x = video.reshape(-1, h, w, c).permute(0, 3, 1, 2).float()
    x = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False)
    return x.permute(0, 2, 3, 1).reshape(*lead, size, size, c)


def i3d_features(videos, i3d_path: str, batch: int = 2,
                 device="cuda") -> np.ndarray:
    """[N, T, H, W, C] in [0, 1] -> [N, 400] I3D logit features, the
    TorchScript I3D (styleganv variant) run on `device`."""
    model = torch.jit.load(i3d_path, map_location=device).eval()
    videos = torch.as_tensor(videos)
    detector_kwargs = dict(rescale=False, resize=False, return_features=True)
    feats = []
    with torch.no_grad():
        for i in range(0, len(videos), batch):
            v = _resize_video(videos[i:i + batch].to(device))
            # [N, T, H, W, C] in [0, 1] -> [N, C, T, H, W] in [-1, 1]
            x = v.permute(0, 4, 1, 2, 3) * 2.0 - 1.0
            feats.append(model(x, **detector_kwargs).cpu().numpy())
    return np.concatenate(feats)


def compute_fvd(videos_real, videos_fake, i3d_path: Optional[str] = None,
                features_real: Optional[np.ndarray] = None,
                features_fake: Optional[np.ndarray] = None,
                device="cuda") -> float:
    """FVD between two video sets [N, T, H, W, C] in [0, 1]; either an
    i3d_path or precomputed features must be given.

    Golden reference: zeros vs ones [8, 30, 3, 64, 64] gives ~151.3 with the
    styleganv I3D (reference README 'Evaluation Example')."""
    if features_real is None or features_fake is None:
        if i3d_path is None:
            raise ValueError(
                "compute_fvd needs i3d_path (torchscript I3D weights; see "
                "reference fvd/styleganv/fvd.py download URL) or "
                "precomputed features")
        features_real = i3d_features(videos_real, i3d_path, device=device)
        features_fake = i3d_features(videos_fake, i3d_path, device=device)
    mu_r, sig_r = gaussian_stats(features_real)
    mu_f, sig_f = gaussian_stats(features_fake)
    return frechet_distance(mu_r, sig_r, mu_f, sig_f)
