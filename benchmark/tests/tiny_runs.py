"""Runs of the benchmark's drivers on the CPU at a tiny size (tiny/: a
2+2-block DiT, small Llama and CLIP towers, a small VAE), through
benchmark/run.py:execute with the chip's look skipped."""
import json
from pathlib import Path

import torch

from benchmark.run import execute

TINY = Path(__file__).resolve().parent / "tiny"


def load(name):
    return json.loads((TINY / name).read_text())


def run(cfg_name, traffic_name, seed=5, seconds=0.05, lim=None,
        precision=None):
    cfg, traffic = load(cfg_name), load(traffic_name)
    if precision:
        cfg["precision"] = cfg["text"]["precision"] = precision
        cfg["vae"]["precision"] = precision
    w = {"name": "tiny", "config": cfg["name"], "traffic": "tiny",
         "chips": 1}
    bench = {"end_to_end": [{"name": n, "unit": "s"} for n in
                            (("step_s",) if traffic["driver"] == "t2v"
                             else ("roundtrip_s",)) + ("setup_s",)],
             "per_layer": []}
    return execute(bench, w, cfg, traffic, seed, seconds, False,
                   torch.device("cpu"), lim=lim or {})
