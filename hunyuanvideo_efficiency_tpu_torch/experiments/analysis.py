"""Experiment result analysis (a copy of the JAX package's
experiments/analysis.py).

Replaces the reference's notebook-based ranking
(reference: analysis.ipynb — pandas ranking of PSNR/SSIM/LPIPS per exp +
bitrate-bucket comparison; theory_analysis.py — YUV frame entropy
exploration) with importable functions + a CLI.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List, Optional

import numpy as np

_METRIC_RE = re.compile(
    r"Average (PSNR|SSIM|LPIPS):\s*([0-9.eE+-]+)", re.IGNORECASE)


def parse_metrics_txt(path: str) -> Dict[str, float]:
    """Parse a metrics_<ts>.txt report (compute_metrics_dir output; same
    layout as the reference's evaluation/results/metrics_*.txt)."""
    out = {}
    with open(path) as f:
        for line in f:
            m = _METRIC_RE.match(line.strip())
            if m:
                out[m.group(1).lower()] = float(m.group(2))
    return out


def collect_experiment_metrics(exp_base: str) -> List[Dict]:
    """Walk exp_* dirs, read the latest metrics report of each."""
    rows = []
    for d in sorted(os.listdir(exp_base)):
        sub = os.path.join(exp_base, d)
        if not (d.startswith("exp_") and os.path.isdir(sub)):
            continue
        reports = sorted(f for f in os.listdir(sub)
                         if f.startswith("metrics_") and f.endswith(".txt"))
        if not reports:
            continue
        row = {"exp": d}
        row.update(parse_metrics_txt(os.path.join(sub, reports[-1])))
        rows.append(row)
    return rows


def rank_table(rows: List[Dict], key: str = "psnr",
               top: Optional[int] = None) -> List[Dict]:
    ascending = key == "lpips"
    rows = [r for r in rows if key in r]
    rows = sorted(rows, key=lambda r: r[key], reverse=not ascending)
    return rows[:top] if top else rows


def frame_entropy(frames: np.ndarray) -> np.ndarray:
    """Shannon entropy (bits) per frame of a uint8 video [T, H, W(, C)]
    (reference: theory_analysis.py YUV frame/entropy exploration)."""
    ent = []
    for f in frames:
        hist = np.bincount(f.reshape(-1).astype(np.uint8), minlength=256)
        p = hist / hist.sum()
        nz = p[p > 0]
        ent.append(float(-(nz * np.log2(nz)).sum()))
    return np.asarray(ent)


def temporal_entropy_rate(frames: np.ndarray) -> float:
    """Mean entropy of frame deltas — how much temporal information the
    t-ops compression discards (theory_analysis companion metric)."""
    if len(frames) < 2:
        return 0.0
    deltas = np.abs(frames[1:].astype(np.int16)
                    - frames[:-1].astype(np.int16)).astype(np.uint8)
    return float(frame_entropy(deltas).mean())


def main():
    import argparse

    p = argparse.ArgumentParser(description="Rank t-ops experiment metrics")
    p.add_argument("exp_base")
    p.add_argument("--rank-by", default="psnr",
                   choices=["psnr", "ssim", "lpips"])
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--json-out", default=None)
    a = p.parse_args()
    rows = rank_table(collect_experiment_metrics(a.exp_base), a.rank_by,
                      a.top)
    for r in rows:
        print(" ".join(f"{k}={v}" for k, v in r.items()))
    if a.json_out:
        with open(a.json_out, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
