"""Driver of the t-ops sweep cells: the fork's VAE experiment, kept on the
card. Set-up builds one VAE of the program a t-ops config (the traffic's
frozen configs, benchmark/tops/), all with the benchmark's weights, and the
program's LPIPS with the benchmark's weights; it draws the traffic's smooth
videos from the seed and warms one round trip under each config. The
window loops over the videos, each under every config in turn: a round
trip is `vae(x, sample_posterior=False)` (what the sweep's `infer_vae`
calls), synchronized, then the program's PSNR, SSIM and LPIPS of the
reconstruction against its input, on uint8 frames as the sweep's `.pt`
interchange gives them. The synchronization after the VAE splits each
round trip into its VAE part, which the VAE's per-layer metrics read, and
its scores. Afterwards one round trip a config, drawn from the seed, is checked
against the plain reference (benchmark/reference/vae.py, scores.py).
"""
from __future__ import annotations

import gc
import json
import random
import time
from pathlib import Path
from typing import Dict, List

import torch

from .. import weights
from ..reference import scores as ref_scores
from ..reference import vae as ref_vae
from ..traffic import smooth_video
from .t2v import DTYPES, load_weights, sync

TOPS = Path(__file__).resolve().parent.parent / "tops"


def tops_config(name: str) -> dict:
    return json.loads((TOPS / f"{name}.json").read_text())


def build(cfg: dict, traffic: dict, seed: int, device):
    """({t-ops name: the program's VAE}, the program's LPIPS)."""
    from hunyuanvideo_efficiency_tpu_torch.evaluation.lpips import (
        lpips_from_state_dict)
    from hunyuanvideo_efficiency_tpu_torch.models.vae import build_vae
    from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
        TOpsConfig, VAEConfig)

    v = cfg["vae"]
    dtype = DTYPES[v["precision"]]
    vcfg = VAEConfig(**{k: tuple(x) if isinstance(x, list) else x
                        for k, x in v.items()
                        if k not in ("name", "precision")})
    vaes = {}
    for name in traffic["tops"]:
        vaes[name] = build_vae(vcfg, device, dtype,
                               tops=TOpsConfig.from_dict(tops_config(name)))
        load_weights(vaes[name], "vae", v, seed, device, dtype)
    (_, lp), = weights.state_dicts("lpips", None, seed, device, torch.float32)
    return vaes, lpips_from_state_dict(lp, device)


def frames(video: torch.Tensor) -> torch.Tensor:
    """[1, 3, T, H, W] in [-1, 1] -> uint8 [T, H, W, 3] (truncation), as the
    sweep's `.pt` interchange reads a reconstruction."""
    x = video[0].float().permute(1, 2, 3, 0)
    return ((x + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def score(lpips_model, x, recon) -> Dict[str, float]:
    """The program's PSNR, SSIM and LPIPS of a round trip, both videos cut
    to their common frames and size (evaluation/compute_metrics.py:
    compute_pair)."""
    from hunyuanvideo_efficiency_tpu_torch.evaluation.lpips import (
        lpips_video)
    from hunyuanvideo_efficiency_tpu_torch.evaluation.metrics import (
        psnr_video, ssim_video)

    a, b = frames(x), frames(recon)
    t, h, w = (min(p, q) for p, q in zip(a.shape[:3], b.shape[:3]))
    a, b = a[:t, :h, :w], b[:t, :h, :w]
    return {"psnr": psnr_video(a, b), "ssim": ssim_video(a, b),
            "lpips": lpips_video(lpips_model, a, b)}


def videos(traffic: dict, seed: int, device) -> List[torch.Tensor]:
    g = torch.Generator(device=device).manual_seed(
        weights.group_seed(seed, "videos"))
    return [smooth_video(g, traffic["frames"], traffic["height"],
                         traffic["width"], traffic["low_grid"])
            for _ in range(traffic["videos"])]


def run(ctx) -> None:
    cfg, traffic, seed, dev = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    ctx.log("set-up: building the VAEs")
    vaes, lp = build(cfg, traffic, seed, dev)
    vids = videos(traffic, seed, dev)
    names = traffic["tops"]
    with torch.no_grad():
        for name in names:
            score(lp, vids[0], vaes[name](vids[0], sample_posterior=False))
    sync(dev)
    ctx.setup_done()

    # which round trip of each config is checked: drawn from the seed (the
    # last one where the window holds fewer)
    rng = random.Random(weights.group_seed(seed, "check"))
    pick = {n: rng.randrange(traffic["videos"]) for n in names}
    kept: Dict[str, tuple] = {}
    done = {n: 0 for n in names}
    trips: List[str] = []
    marks: List[float] = []      # each round trip's end
    vae_s: List[float] = []      # each round trip's VAE part
    counts = [ctx.read_counts()]
    ctx.window_start()
    i = 0
    with ctx.recorder(), torch.no_grad():
        sync(dev)          # the profiler, when on, has started
        t0 = time.perf_counter()
        ctx.mark()
        while True:
            vi, name = divmod(i, len(names))
            vi %= len(vids)
            name = names[name]
            start = marks[-1] if marks else t0
            recon = vaes[name](vids[vi], sample_posterior=False)
            # the scores' first host read waits for the reconstruction
            # anyway: this synchronization splits the round trip at no cost
            sync(dev)
            vae_s.append(time.perf_counter() - start)
            ctx.mark()
            got = score(lp, vids[vi], recon)
            if done[name] <= pick[name]:
                kept[name] = (vi, recon, got)
            done[name] += 1
            trips.append(name)
            marks.append(time.perf_counter())
            ctx.mark()
            i += 1
            # the window closes at the end of a whole cycle of the
            # configs, so that every run times the same mix
            if marks[-1] - t0 >= ctx.seconds and i % len(names) == 0:
                break
    counts.append(ctx.read_counts())
    ctx.window_end()
    window = marks[-1] - t0
    ctx.e2e["roundtrip_s"] = window / len(trips)
    ctx.attempted, ctx.failed = len(trips), 0
    # the VAE parts [trip start, VAE end] in the trace's clock
    parts = [(ctx.marks[2 * j], ctx.marks[2 * j + 1])
             for j in range(len(trips))]
    ctx.per_layer_span(first_mark=0, last_mark=2 * len(trips),
                       units=len(trips),
                       launches={k: counts[1][k] - counts[0][k]
                                 for k in counts[0]},
                       vae_parts=parts,
                       score_s=(window - sum(vae_s)) / len(trips))
    ctx.shapes = dict(traffic=traffic, trips=trips)
    ctx.log(f"window: {len(trips)} round trips, {window:.4f} s: the VAE "
            f"{sum(vae_s):.4f} s, the scores {window - sum(vae_s):.4f} s")
    del vaes, lp, recon
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, vids, kept)


def reference_trip(cfg, seed, x, tops_name, tier=None):
    dev = x.device
    vae = ref_vae.load(cfg["vae"], seed, dev, DTYPES[cfg["vae"]["precision"]],
                       tier)
    with torch.no_grad():
        return vae.roundtrip(x.float(), tops_config(tops_name))


def lpips_weights(seed, device):
    (_, sd), = weights.state_dicts("lpips", None, seed, device, torch.float32)
    return sd


def score_gaps(got: dict, want: dict):
    """(the worst relative gap of PSNR and SSIM, that of LPIPS)."""
    def rel(k):
        return abs(got[k] - want[k]) / max(abs(want[k]), 1e-12)

    return max(rel("psnr"), rel("ssim")), rel("lpips")


def check(ctx, vids, kept) -> None:
    """recon_rel_l2: the worst checked reconstruction against the
    reference's; metric_gap, lpips_gap: the worst relative gap between the
    program's scores and the reference's scores of the program's own
    frames (PSNR and SSIM in float64, LPIPS)."""
    cfg, seed = ctx.cfg, ctx.seed
    dev = vids[0].device
    lp = lpips_weights(seed, dev)
    rel = gap = lgap = 0.0
    with no_tf32():
        for name, (vi, recon, got) in kept.items():
            ref = reference_trip(cfg, seed, vids[vi], name)
            rel = max(rel, float((recon.float() - ref).norm()
                                 / ref.norm().clamp_min(1e-30))
                      if recon.shape == ref.shape else float("inf"))
            g, lg = score_gaps(got, ref_scores.scores(lp, vids[vi], recon))
            gap, lgap = max(gap, g), max(lgap, lg)
    ctx.checks["recon_rel_l2"] = rel
    ctx.checks["metric_gap"] = gap
    ctx.checks["lpips_gap"] = lgap
    ctx.log(f"check: {len(kept)} round trips against the reference done")


class no_tf32:
    """The reference's products in full fp32, restored after."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
        return False
