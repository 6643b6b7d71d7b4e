"""Driver of the guidance-distilled text-to-video cell: one client, one
`predict()` at a time, in the released HunyuanVideo checkpoint's mode.

As drivers/t2v.py, whose set-up, inputs, warm step and window it keeps,
with `predict(..., guidance_scale=1.0, embedded_guidance_scale=g)`: one
batch-1 DiT forward a step, the guidance strength fed through the model's
guidance embedder, no negative prompt encoded. Afterwards the program is
freed and the plain reference (reference/dit_cfgdistill.py) recomputes,
from the same weights and inputs, the velocity v = DiT(x, t, g) of one of
the window's steps, drawn from the seed among the first CHECK_STEPS (the
window's last where it holds fewer), from the program's latent before that
step, with its products in float32 (TF32 off) and the attention's operands
in fp16. The program's velocity is read off its latents, (x_{i+1} - x_i) /
(sigma_{i+1} - sigma_i).

The readings that the cell's limits are set from (benchmark/control.py's
counterpart for this cell), from the root of a checkout:

    python3 -m benchmark.drivers.t2v_cfgdistill --workload <cell> \\
        --seconds S [--control SEED ...] [--sound SEED ...]

`--sound`: a run of the program as the configuration states it, each seed
in turn; `--control`: `reference_control`, the reference with float8_e4m3
operands against it in float32 at the first step. One JSON line a
reading. Needs CUDA.
"""
from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import torch

from .. import weights
from ..reference import dit as ref_dit
from ..reference import dit_cfgdistill as ref
from ..reference import text as ref_text
from .t2v import (CHECK_STEPS, StopWindow, build_sampler, inputs, noise,
                  program_velocity, rel_l2, sync)
from .vae_tops import no_tf32


def predict_steps(sampler, traffic: dict, text: str, video_seed: int,
                  on_step) -> None:
    """One predict() of the cell's traffic with its embedded guidance;
    `on_step(i, latents)` after each step may raise StopWindow to end
    it."""
    try:
        sampler.predict(
            text, height=traffic["height"], width=traffic["width"],
            video_length=traffic["video_length"], seed=video_seed,
            infer_steps=traffic["infer_steps"],
            guidance_scale=traffic["guidance_scale"],
            embedded_guidance_scale=traffic["embedded_guidance_scale"],
            flow_shift=traffic["flow_shift"], progress_callback=on_step)
    except StopWindow:
        return
    raise RuntimeError("the video finished inside the window: the window "
                       "must end before the last step")


def run(ctx) -> None:
    """Set-up, warm-up, the window and the check of one run; fills `ctx`
    (benchmark/run.py's Run)."""
    cfg, traffic, seed, dev = ctx.cfg, ctx.traffic, ctx.seed, ctx.device
    if traffic["guidance_scale"] != 1.0:
        raise ValueError("the guidance-distilled cell runs without CFG "
                         "(guidance_scale 1.0)")
    ctx.log("set-up: building the sampler")
    sampler = build_sampler(cfg, seed, dev)
    text, video_seed = inputs(traffic, seed)
    ctx.log("set-up: one warm step")

    def warm(i, lat):
        raise StopWindow

    predict_steps(sampler, traffic, text, video_seed, warm)
    sync(dev)
    ctx.setup_done()

    marks: List[float] = []
    counts: List[Dict[str, int]] = []
    keep: Dict[int, torch.Tensor] = {}
    pick = random.Random(weights.group_seed(seed, "check")).randrange(
        CHECK_STEPS)

    def on_step(i, lat):
        sync(dev)
        marks.append(time.perf_counter())
        counts.append(ctx.read_counts())
        ctx.mark()
        # x_{i+1}; kept: x_pick, x_{pick+1} and the last two
        keep[i + 1] = lat.clone()
        for j in [j for j in keep if j < i and j not in (pick, pick + 1)]:
            del keep[j]
        if marks[-1] - t0 >= ctx.seconds:
            raise StopWindow

    ctx.window_start()
    t0 = time.perf_counter()
    with ctx.recorder():
        predict_steps(sampler, traffic, text, video_seed, on_step)
    steps = len(marks)
    ctx.window_end()
    ctx.e2e["step_s"] = (marks[-1] - t0) / steps
    ctx.attempted, ctx.failed = steps, 0
    ctx.per_layer_span(first_mark=0, last_mark=steps - 1,
                       units=steps - 1,
                       launches={k: counts[-1][k] - counts[0][k]
                                 for k in counts[0]})
    ctx.shapes = dict(traffic=traffic,
                      text_valid=[ref_text.text_valid(text, cfg["text"])],
                      batch=1)

    ctx.log(f"window: {steps} steps")
    lat = {i: x.float() for i, x in keep.items()}
    del sampler, keep
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    check(ctx, text, video_seed, lat, min(pick, steps - 1))


def reference_velocity(cfg, traffic, seed, text, step, x, control=False):
    """The plain reference's velocity at `step` from the latent x [1, C,
    T, H, W], in float32 or (`control`) with float8_e4m3 operands."""
    sig = ref_dit.sigmas(traffic["infer_steps"], traffic["flow_shift"])
    tx = ref_text.encode([text], cfg["text"], seed, x.device)
    attn = torch.float16 if x.device.type == "cuda" else torch.float32
    (v,) = ref.velocities(cfg, seed, [x], [float(sig[step]) * 1000.0], tx,
                          traffic["embedded_guidance_scale"], control, attn)
    return v


def check(ctx, text, video_seed, lat, step) -> None:
    """v_rel_l2: the program's velocity at `step` against the reference's
    from the same latent."""
    cfg, traffic, seed = ctx.cfg, ctx.traffic, ctx.seed
    sig = ref_dit.sigmas(traffic["infer_steps"], traffic["flow_shift"])
    if step == 0:
        lat[0] = noise(cfg, traffic, video_seed, lat[1].device)
    prog = program_velocity(lat, sig, step)
    with no_tf32():
        want = reference_velocity(cfg, traffic, seed, text, step, lat[step])
    ctx.checks["v_rel_l2"] = rel_l2(prog, want)
    ctx.log(f"check: reference of step {step} done")


def reference_control(run) -> dict:
    """v_rel_l2 of the reference with float8_e4m3 operands (the
    configuration's `control.reference_tier`) against it in float32, at
    the first step from the seeded noise."""
    if run.cfg["control"]["reference_tier"] != "fp8":
        raise NotImplementedError("the reference's control is fp8 only")
    cfg, traffic = run.cfg, run.traffic
    text, video_seed = inputs(traffic, run.seed)
    x0 = noise(cfg, traffic, video_seed, run.device)
    with no_tf32():
        want = reference_velocity(cfg, traffic, run.seed, text, 0, x0)
        got = reference_velocity(cfg, traffic, run.seed, text, 0, x0,
                                 control=True)
    return {"v_rel_l2": rel_l2(got, want)}


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    from ..run import ROOT, Run, cache_env, cell

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--sound", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    cache_env(ROOT)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib

    cuda_lib.build()
    _, w, cfg, traffic = cell(a.workload)
    dev = torch.device("cuda", 0)
    for kind, seeds in (("control", a.control), ("sound", a.sound)):
        for seed in seeds:
            r = Run(w["name"], cfg, traffic, seed, a.seconds, False, dev)
            if kind == "sound":
                run(r)
                checks = r.checks
            else:
                checks = reference_control(r)
            print(json.dumps({"workload": w["name"], "kind": kind,
                              "seed": seed, "checks": checks,
                              "steps_or_trips": r.attempted}), flush=True)
            del r
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    import os
    import sys

    if os.environ.get("PYTHONHASHSEED") != "0":
        # the tokenizer stand-in hashes words with `hash`: fix its salt
        os.environ["PYTHONHASHSEED"] = "0"
        os.execv(sys.executable, [sys.executable, "-m", __spec__.name]
                 + sys.argv[1:])
    sys.exit(main())
