"""Per-video bitrate extraction for metric bucketing (a copy of the JAX
package's data/video_bit_rate.py; reference: dataset_processor/video_bit_rate.py:1-48 uses ffprobe; here we
compute from container size / duration via OpenCV, with an ffprobe fallback
when the binary exists)."""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Optional


def video_bit_rate(path: str) -> Optional[float]:
    """Bits per second, or None if it cannot be determined."""
    if shutil.which("ffprobe"):
        try:
            out = subprocess.check_output(
                ["ffprobe", "-v", "error", "-select_streams", "v:0",
                 "-show_entries", "format=bit_rate", "-of",
                 "default=noprint_wrappers=1:nokey=1", path],
                text=True).strip()
            if out and out != "N/A":
                return float(out)
        except (subprocess.CalledProcessError, ValueError):
            pass
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    fps = cap.get(cv2.CAP_PROP_FPS) or 0
    frames = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0
    cap.release()
    if fps <= 0 or frames <= 0:
        return None
    duration = frames / fps
    return os.path.getsize(path) * 8 / duration


def write_bitrate_table(video_dir: str, out_txt: str) -> Dict[str, float]:
    """`<name> <bitrate>` lines, sorted by name (bucketing input)."""
    rates = {}
    for f in sorted(os.listdir(video_dir)):
        if f.lower().endswith((".mp4", ".mov", ".mkv", ".avi")):
            r = video_bit_rate(os.path.join(video_dir, f))
            if r is not None:
                rates[f] = r
    with open(out_txt, "w") as fh:
        for name, r in rates.items():
            fh.write(f"{name} {r:.0f}\n")
    return rates
