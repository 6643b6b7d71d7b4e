"""mp4 -> tensor preprocessing (JAX counterpart: data/mp42tensor.py;
reference: dataset_processor/mp42tensor.py).

Decodes a video, resizes the short side to `target_short` (240p by default),
converts to an RGB float tensor [C, T, H, W] scaled to [-1, 1], and saves it
in torch `.pt` format. The threaded batch conversion mirrors the
reference. OpenCV (cv2) is imported inside the functions that decode or
encode video; the rest of the port runs without it.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch


def video_to_tensor(path: str, target_short: Optional[int] = 240,
                    max_frames: Optional[int] = None) -> torch.Tensor:
    """Decode mp4 -> float32 [C, T, H, W] in [-1, 1]
    (reference: mp42tensor.py resize + /127.5 - 1 convention)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"Cannot open video: {path}")
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if target_short:
            h, w = frame.shape[:2]
            if min(h, w) > target_short:
                scale = target_short / min(h, w)
                frame = cv2.resize(
                    frame, (int(round(w * scale)), int(round(h * scale))),
                    interpolation=cv2.INTER_AREA)
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"No frames decoded from {path}")
    arr = np.stack(frames).astype(np.float32) / 127.5 - 1.0  # [T, H, W, C]
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(3, 0, 1, 2)))


def convert_dir(input_dir: str, output_dir: str,
                target_short: Optional[int] = 240,
                max_frames: Optional[int] = None,
                num_workers: int = 8) -> List[str]:
    """Threaded mp4 dir -> .pt dir (reference uses a thread pool likewise)."""
    from .dataset_loader import save_tensor

    os.makedirs(output_dir, exist_ok=True)
    videos = sorted(f for f in os.listdir(input_dir)
                    if f.lower().endswith((".mp4", ".mov", ".mkv", ".avi")))

    def one(name: str) -> str:
        out = os.path.join(output_dir, os.path.splitext(name)[0] + ".pt")
        save_tensor(out, video_to_tensor(os.path.join(input_dir, name),
                                         target_short, max_frames))
        return out

    with ThreadPoolExecutor(num_workers) as ex:
        return list(ex.map(one, videos))


def tensor_to_video(video, path: str, fps: int = 24) -> None:
    """[C, T, H, W] in [-1, 1] (tensor or array) -> mp4."""
    import cv2

    arr = np.asarray(torch.as_tensor(video).float().cpu())
    c, t, h, w = arr.shape
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    frames = ((arr.transpose(1, 2, 3, 0) + 1.0) * 127.5).clip(0, 255)
    for f in frames.astype(np.uint8):
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
