"""The readings that the limits of a cell's checks are set from.

    python3 benchmark/control.py --workload <name> --seconds <s> \
        [--control SEED ...] [--sound SEED ...]

For each `--sound` seed a run of the program as the configuration states
it (set-up, a short window at the cell's own load, the check); for each
`--control` seed the same check with the control in the program's place,
the nearest precision below the configuration's:

* t2v: the plain reference in the configuration's `control.reference_tier`
  ("fp8" for bf16: every block linear's and attention's operands in
  float8_e4m3; 4 for the int8 tiers: W4A4 linears and int4 STA scores) in
  the program's place, against the reference in the configuration's own
  tiers, at the first step from the seeded noise. The program's own
  `--use-fp8` (a storage tier: it computes in bf16) and `--use-int8` (the
  linears only) read under 3 times the sound runs (PERF.md) and do not
  serve;
* the t-ops round trips: the plain reference VAE with every conv, linear
  and attention operand rounded to the configuration's
  `control.vae_reference_tier` ("bf16" for the fp16 VAE), PSNR and SSIM
  in float32 and LPIPS in bfloat16, one round trip a config.

One process, every seed in turn (set-up is long); one JSON line a reading
on standard output. Needs CUDA. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    os.environ["PYTHONHASHSEED"] = "0"
    os.execv(sys.executable, [sys.executable] + sys.argv)
sys.path.insert(0, str(ROOT))


def t2v_reference_control(run) -> dict:
    """v_rel_l2 of the reference in the control's tiers against it in the
    configuration's, at the first step from the seeded noise."""
    from benchmark.drivers import t2v

    cfg, traffic = run.cfg, run.traffic
    text, video_seed = t2v.inputs(traffic, run.seed)
    x0 = t2v.noise(cfg, traffic, video_seed, run.device)
    with t2v.tf32():
        want = t2v.reference_velocities(cfg, traffic, run.seed, text,
                                        {0: x0})[0]
        got = t2v.reference_velocities(cfg, traffic, run.seed, text,
                                       {0: x0}, control=True)[0]
    return {"v_rel_l2": t2v.rel_l2(got, want)}


def vae_reference_control(run) -> dict:
    """recon_rel_l2, metric_gap and lpips_gap of the reference VAE in the
    control's operand tier with the control's scores (float32 PSNR and
    SSIM, bfloat16 LPIPS) against the fp32 reference VAE with float64
    scores."""
    from benchmark import weights
    from benchmark.drivers import vae_tops as vt
    from benchmark.reference import scores as ref_scores

    vids = vt.videos(run.traffic, run.seed, run.device)
    rng = random.Random(weights.group_seed(run.seed, "check"))
    lp = vt.lpips_weights(run.seed, run.device)
    tier = run.cfg["control"]["vae_reference_tier"]
    rel = gap = lgap = 0.0
    with vt.no_tf32():
        for name in run.traffic["tops"]:
            x = vids[rng.randrange(len(vids))]
            got = vt.reference_trip(run.cfg, run.seed, x, name, tier)
            want = vt.reference_trip(run.cfg, run.seed, x, name)
            rel = max(rel, float((got - want).norm() / want.norm()))
            g, lg = vt.score_gaps(ref_scores.scores(lp, x, got, True),
                                  ref_scores.scores(lp, x, got))
            gap, lgap = max(gap, g), max(lgap, lg)
    return {"recon_rel_l2": rel, "metric_gap": gap, "lpips_gap": lgap}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", type=int, nargs="*", default=[])
    p.add_argument("--sound", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    from benchmark.run import Run, cache_env, cell

    cache_env(ROOT)
    import importlib

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib

    cuda_lib.build()
    _, w, cfg, traffic = cell(a.workload)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    dev = torch.device("cuda", 0)
    for kind, seeds in (("control", a.control), ("sound", a.sound)):
        for seed in seeds:
            run = Run(w["name"], cfg, traffic, seed, a.seconds, False, dev)
            if kind == "sound":
                driver.run(run)
                checks = run.checks
            elif traffic["driver"] == "vae_tops":
                checks = vae_reference_control(run)
            else:
                checks = t2v_reference_control(run)
            print(json.dumps({"workload": w["name"], "kind": kind,
                              "seed": seed, "checks": checks,
                              "steps_or_trips": run.attempted}), flush=True)
            del run
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
