"""Frechet Video Motion Distance (FVMD) — first-party implementation (a
copy of the JAX package's evaluation/fvmd.py: numpy on the host, cv2
imported where the tracker needs it).

The reference computes FVMD through the external ``fvmd`` pip package
(reference: rebuttal/common_metrics_on_video_quality/run.py:19-23, 80-86:
``track_keypoints`` -> ``calc_hist`` -> ``calculate_fd_given_vectors``).
That package tracks keypoints with a learned point tracker (PIPs++),
builds velocity/acceleration motion histograms per video segment, and
takes the Frechet distance between the histogram sets (Liu et al.,
"Frechet Video Motion Distance", arXiv 2407.16124).

This module re-provides the metric first-party with no learned tracker:

* ``track_keypoints``: a uniform query grid tracked frame-to-frame with
  pyramidal Lucas-Kanade optical flow (cv2.calcOpticalFlowPyrLK chained
  across the segment, status-masked so lost points stop contributing).
* ``calc_hist``: velocity (first difference of trajectories) and
  acceleration (second difference) fields quantized into
  magnitude-weighted orientation histograms — ``n_angle_bins``
  orientations x ``n_mag_bins`` log-spaced magnitude bins — per segment,
  velocity and acceleration concatenated.
* ``fvmd``: Gaussian statistics of the two histogram sets -> Frechet
  distance (same core as FVD, metrics.frechet_distance).

Because the tracker differs from the pip package's learned one, absolute
values are not interchangeable with published FVMD numbers; the metric
preserves the construction (motion-feature Frechet distance) and ordering.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .metrics import frechet_distance, gaussian_stats

SEGMENT_LEN = 16  # the fvmd package scores 16-frame clips


def _to_gray_u8(video: np.ndarray) -> np.ndarray:
    """[T, H, W, C] or [T, H, W] float/uint8 -> [T, H, W] uint8 gray."""
    v = np.asarray(video)
    if v.dtype != np.uint8:
        # [0, 1]-range detection tolerates decoder overshoot (e.g. a VAE
        # decode peaking at 1.02 is still unit-range data, not 0-255)
        unit_range = v.max() <= 2.0
        v = np.clip(v, 0.0, 1.0 if unit_range else 255.0)
        if unit_range:
            v = v * 255.0
        v = v.astype(np.uint8)
    if v.ndim == 4:
        # ITU-R BT.601 luma; avoids a cv2 call per frame.
        v = (0.299 * v[..., 0] + 0.587 * v[..., 1]
             + 0.114 * v[..., 2]).astype(np.uint8)
    return v


def track_keypoints(video: np.ndarray, grid: int = 32,
                    lk_win: int = 21, lk_levels: int = 3
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Track a uniform grid of keypoints across one video segment.

    video: [T, H, W(, C)]. Returns (tracks [T, N, 2] float32 xy,
    valid [N] bool — points whose LK status stayed 1 for every step).
    """
    import cv2

    gray = _to_gray_u8(video)
    t, h, w = gray.shape
    xs = np.linspace(0, w - 1, grid, dtype=np.float32)
    ys = np.linspace(0, h - 1, grid, dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)  # [N, 2]
    n = pts.shape[0]

    tracks = np.empty((t, n, 2), np.float32)
    tracks[0] = pts
    valid = np.ones(n, bool)
    prev = pts.reshape(-1, 1, 2).astype(np.float32)
    lk = dict(winSize=(lk_win, lk_win), maxLevel=lk_levels,
              criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT,
                        30, 0.01))
    for i in range(1, t):
        nxt, status, _ = cv2.calcOpticalFlowPyrLK(
            gray[i - 1], gray[i], prev, None, **lk)
        status = status.ravel().astype(bool)
        nxt = nxt.reshape(-1, 2)
        # Lost points freeze in place and are masked out of the features.
        nxt[~status] = prev.reshape(-1, 2)[~status]
        valid &= status
        tracks[i] = nxt
        prev = nxt.reshape(-1, 1, 2)
    return tracks, valid


def calc_hist(tracks: np.ndarray, valid: np.ndarray,
              n_angle_bins: int = 8, n_mag_bins: int = 16,
              max_mag: float = 32.0) -> np.ndarray:
    """Motion histogram feature for one tracked segment.

    tracks [T, N, 2], valid [N] -> feature [2 * n_angle_bins * n_mag_bins]
    (velocity histogram then acceleration histogram, each L1-normalized
    magnitude-weighted counts over orientation x log-magnitude bins).
    """
    vel = np.diff(tracks, axis=0)          # [T-1, N, 2]
    acc = np.diff(vel, axis=0)             # [T-2, N, 2]

    def hist(field: np.ndarray) -> np.ndarray:
        f = field[:, valid, :].reshape(-1, 2)
        mag = np.hypot(f[:, 0], f[:, 1])
        ang = np.arctan2(f[:, 1], f[:, 0])  # [-pi, pi]
        a_idx = np.minimum(
            ((ang + np.pi) / (2 * np.pi) * n_angle_bins).astype(np.int64),
            n_angle_bins - 1)
        # log-spaced magnitude bins over (0, max_mag]; stills land in bin 0
        m = np.clip(mag, 1e-3, max_mag)
        m_idx = np.minimum(
            (np.log(m / 1e-3) / np.log(max_mag / 1e-3)
             * n_mag_bins).astype(np.int64),
            n_mag_bins - 1)
        h = np.zeros(n_angle_bins * n_mag_bins, np.float64)
        np.add.at(h, a_idx * n_mag_bins + m_idx, mag)
        total = h.sum()
        return h / total if total > 0 else h

    return np.concatenate([hist(vel), hist(acc)]).astype(np.float32)


def video_motion_features(videos: np.ndarray, segment_len: int = SEGMENT_LEN,
                          grid: int = 32) -> np.ndarray:
    """[N, T, H, W, C] -> [n_segments_total, D] motion histogram matrix.

    Each video is split into non-overlapping ``segment_len``-frame clips
    (trailing remainder >= 3 frames forms a final shorter clip — velocity
    and acceleration need 3 frames)."""
    feats = []
    for video in videos:
        t = video.shape[0]
        starts = list(range(0, max(t - segment_len + 1, 1), segment_len))
        for s in starts:
            seg = video[s:s + segment_len]
            if seg.shape[0] < 3:
                continue
            tracks, valid = track_keypoints(seg, grid=grid)
            if not valid.any():
                continue
            feats.append(calc_hist(tracks, valid))
        rem = t - (starts[-1] + segment_len)
        if rem >= 3:
            seg = video[starts[-1] + segment_len:]
            tracks, valid = track_keypoints(seg, grid=grid)
            if valid.any():
                feats.append(calc_hist(tracks, valid))
    if not feats:
        raise ValueError("no trackable segments (need >= 3 frames)")
    return np.stack(feats)


def fvmd(videos_gt: np.ndarray, videos_gen: np.ndarray,
         segment_len: int = SEGMENT_LEN, grid: int = 32) -> float:
    """Frechet Video Motion Distance between two video sets
    [N, T, H, W, C] (uint8 or float; reference: run.py:80-86)."""
    f1 = video_motion_features(videos_gt, segment_len, grid)
    f2 = video_motion_features(videos_gen, segment_len, grid)
    mu1, s1 = gaussian_stats(f1)
    mu2, s2 = gaussian_stats(f2)
    return frechet_distance(mu1, s1, mu2, s2)
