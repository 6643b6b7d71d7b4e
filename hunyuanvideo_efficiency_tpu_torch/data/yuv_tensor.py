"""Raw YUV reader -> RGB tensors / mp4 (JAX counterpart:
data/yuv_tensor.py; reference: dataset_processor/yuv_tensor.py:41-264).

Supports I420, YV12 and NV12 layouts; geometry (WxH, fps) is parsed from the
filename per the reference convention `name_WxH_fps.yuv` (or passed
explicitly). Output matches mp42tensor: [C, T, H, W] float32 in [-1, 1],
as torch tensors; OpenCV (cv2) is imported inside the functions.
"""
from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

_GEOM_RE = re.compile(r"(\d{2,5})x(\d{2,5})(?:[_x](\d{1,3}))?")


def parse_geometry(filename: str) -> Tuple[int, int, int]:
    """Parse (width, height, fps) from a filename like `foo_1920x1080_30.yuv`
    (reference parses WxH/fps from the name likewise)."""
    m = _GEOM_RE.search(os.path.basename(filename))
    if not m:
        raise ValueError(f"Cannot parse WxH from {filename}")
    w, h, fps = int(m.group(1)), int(m.group(2)), int(m.group(3) or 30)
    return w, h, fps


def _yuv_frame_to_rgb(y, u, v):
    """BT.601 full-range conversion (matches OpenCV COLOR_YUV2RGB_I420)."""
    import cv2

    h, w = y.shape
    u_full = cv2.resize(u, (w, h), interpolation=cv2.INTER_LINEAR)
    v_full = cv2.resize(v, (w, h), interpolation=cv2.INTER_LINEAR)
    yuv = np.stack([y, u_full, v_full], axis=-1).astype(np.uint8)
    return cv2.cvtColor(yuv, cv2.COLOR_YUV2RGB)


def read_yuv(path: str, width: Optional[int] = None,
             height: Optional[int] = None, fmt: str = "I420",
             max_frames: Optional[int] = None) -> torch.Tensor:
    """Read a raw YUV file -> RGB uint8 [T, H, W, 3]."""
    if width is None or height is None:
        width, height, _ = parse_geometry(path)
    ysize = width * height
    csize = ysize // 4
    frame_bytes = ysize + 2 * csize
    frames = []
    with open(path, "rb") as f:
        while True:
            buf = f.read(frame_bytes)
            if len(buf) < frame_bytes:
                break
            raw = np.frombuffer(buf, np.uint8)
            y = raw[:ysize].reshape(height, width)
            if fmt.upper() == "I420":
                u = raw[ysize:ysize + csize].reshape(height // 2, width // 2)
                v = raw[ysize + csize:].reshape(height // 2, width // 2)
            elif fmt.upper() == "YV12":
                v = raw[ysize:ysize + csize].reshape(height // 2, width // 2)
                u = raw[ysize + csize:].reshape(height // 2, width // 2)
            elif fmt.upper() == "NV12":
                uv = raw[ysize:].reshape(height // 2, width)
                u, v = uv[:, 0::2], uv[:, 1::2]
            else:
                raise ValueError(f"Unsupported YUV format: {fmt}")
            frames.append(_yuv_frame_to_rgb(y, u, v))
            if max_frames and len(frames) >= max_frames:
                break
    if not frames:
        raise ValueError(f"No frames in {path}")
    return torch.from_numpy(np.stack(frames))


def yuv_to_tensor(path: str, resize_short: Optional[int] = None,
                  fmt: str = "I420",
                  max_frames: Optional[int] = None) -> torch.Tensor:
    """YUV file -> float32 [C, T, H, W] in [-1, 1] (+ optional resize)."""
    import cv2

    frames = read_yuv(path, fmt=fmt, max_frames=max_frames).numpy()
    if resize_short:
        t, h, w, _ = frames.shape
        if min(h, w) > resize_short:
            scale = resize_short / min(h, w)
            size = (int(round(w * scale)), int(round(h * scale)))
            frames = np.stack([
                cv2.resize(f, size, interpolation=cv2.INTER_AREA)
                for f in frames])
    arr = frames.astype(np.float32) / 127.5 - 1.0
    return torch.from_numpy(np.ascontiguousarray(arr.transpose(3, 0, 1, 2)))


def yuv_to_mp4(path: str, out_path: str, fps: Optional[int] = None,
               fmt: str = "I420") -> None:
    import cv2

    if fps is None:
        _, _, fps = parse_geometry(path)
    frames = read_yuv(path, fmt=fmt).numpy()
    t, h, w, _ = frames.shape
    vw = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()
