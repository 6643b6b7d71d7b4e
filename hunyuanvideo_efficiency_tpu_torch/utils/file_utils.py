"""Video saving utilities (reference: hyvideo/utils/file_utils.py:47); a
copy of the JAX package's utils/file_utils.py for torch tensors.

Writes an mp4 grid from a video [B, C, T, H, W] with values in [0, 1]
(or uint8), as a torch tensor or numpy array.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _to_numpy(x):
    if hasattr(x, "detach"):  # torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def save_videos_grid(videos, path: str, rescale: bool = False, n_rows: int = 1,
                     fps: int = 24) -> str:
    """Save [B, C, T, H, W] video batch as an mp4 grid.

    rescale=True maps [-1, 1] -> [0, 1] first.
    """
    videos = _to_numpy(videos)
    if videos.dtype == np.uint8:
        videos = videos.astype(np.float32) / 255.0
    else:
        videos = videos.astype(np.float32)
    if videos.ndim == 4:  # [C, T, H, W]
        videos = videos[None]
    b, c, t, h, w = videos.shape
    if rescale:
        videos = (videos + 1.0) / 2.0
    videos = np.clip(videos, 0.0, 1.0)

    n_rows = max(1, min(n_rows, b))
    n_cols = (b + n_rows - 1) // n_rows
    pad = n_rows * n_cols - b
    if pad:
        videos = np.concatenate([videos, np.zeros((pad, c, t, h, w), videos.dtype)], 0)
    # [B, C, T, H, W] -> [T, rows*H, cols*W, C]
    grid = videos.reshape(n_rows, n_cols, c, t, h, w)
    grid = grid.transpose(3, 0, 4, 1, 5, 2).reshape(t, n_rows * h, n_cols * w, c)
    frames = (grid * 255.0).round().astype(np.uint8)
    if c == 1:
        frames = np.repeat(frames, 3, axis=-1)

    Path(os.path.dirname(path) or ".").mkdir(parents=True, exist_ok=True)
    try:
        import imageio.v2 as imageio

        writer = imageio.get_writer(path, fps=fps, codec="libx264",
                                    quality=8, macro_block_size=1)
        try:
            for frame in frames:
                writer.append_data(frame)
        finally:
            writer.close()
    except Exception:
        # no ffmpeg binary in minimal images — OpenCV mp4v fallback
        import cv2

        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (frames.shape[2], frames.shape[1]))
        for frame in frames:
            vw.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        vw.release()
    return path
