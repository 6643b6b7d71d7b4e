"""The guidance-distilled cell on the CPU at a tiny size (tiny/
tiny-cfgdistill.json: 2+2 blocks with guidance_in): its driver through
run.execute against its own plain reference in float32; a run whose
program drops the embedded guidance reads `correct` false; the reference's
guidance term moves the velocity by far more than the limit; and
embed_ms.step's checks of its span and of the DiT rows counted a step."""
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.drivers import t2v_cfgdistill as driver
from benchmark.run import Run, execute, read_metric
from benchmark.trace import Trace
from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod
from hunyuanvideo_efficiency_tpu_torch.utils.profiling import (clear_spans,
                                                               span)

from . import tiny_runs

CFG, TRAFFIC = "tiny-cfgdistill.json", "tiny-t2v-cfgdistill.json"
# bf16 runs of this size read ~0.009, a run without guidance ~0.7
LIMIT = {"v_rel_l2": {"limit": 0.03}}
BENCH = {"end_to_end": [{"name": "step_s", "unit": "s"},
                        {"name": "setup_s", "unit": "s"}],
         "per_layer": []}


def run(seed=5, precision=None, lim=None):
    cfg, traffic = tiny_runs.load(CFG), tiny_runs.load(TRAFFIC)
    if precision:
        cfg["precision"] = cfg["text"]["precision"] = precision
        cfg["vae"]["precision"] = precision
    w = {"name": "tiny", "config": cfg["name"], "traffic": "tiny",
         "chips": 1}
    return execute(BENCH, w, cfg, traffic, seed, 0.05, False,
                   torch.device("cpu"), lim=LIMIT if lim is None else lim)


def test_step_matches_the_reference():
    r = run(precision="fp32")
    assert r["checks"]["v_rel_l2"]["value"] < 1e-4
    assert set(r["metrics"]) == {"step_s", "setup_s"}


def test_sound_run_is_correct():
    assert run()["correct"]


def test_run_without_embedded_guidance_is_not_correct(monkeypatch):
    """The program's DiT gets guidance 0 in place of 6000."""
    orig = dit_mod.HYVideoDiT.forward

    def forward(self, x, t, ts, tm, ts2, cos, sin, guidance=None, **kw):
        return orig(self, x, t, ts, tm, ts2, cos, sin,
                    torch.zeros_like(guidance), **kw)

    monkeypatch.setattr(dit_mod.HYVideoDiT, "forward", forward)
    r = run()
    assert r["correct"] is False, r["checks"]


def test_reference_guidance_term_matters():
    cfg, traffic = tiny_runs.load(CFG), tiny_runs.load(TRAFFIC)
    cfg["precision"] = cfg["text"]["precision"] = "fp32"
    text, video_seed = driver.inputs(traffic, 5)
    x = driver.noise(cfg, traffic, video_seed, torch.device("cpu"))
    with_g = driver.reference_velocity(cfg, traffic, 5, text, 0, x)
    traffic["embedded_guidance_scale"] = None
    without = driver.reference_velocity(cfg, traffic, 5, text, 0, x)
    assert driver.rel_l2(without, with_g) > 10 * LIMIT["v_rel_l2"]["limit"]


def test_control_fails():
    run_ = Run("tiny", tiny_runs.load(CFG), tiny_runs.load(TRAFFIC), 5,
               0.05, False, torch.device("cpu"))
    got = driver.reference_control(run_)["v_rel_l2"]
    assert got > LIMIT["v_rel_l2"]["limit"]
    assert got >= 3 * run()["checks"]["v_rel_l2"]["value"]


def traced(steps, embeds_a_step, rows):
    """A Run whose window holds `steps` step spans, each with
    `embeds_a_step` dit.embed spans, and `rows` DiT rows counted."""
    clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.time_ns()
        for _ in range(steps):
            with span("step"):
                for _ in range(embeds_a_step):
                    with span("dit.embed"):
                        time.sleep(0.001)
        t1 = time.time_ns()
    r = Run("x", {}, {}, 1, 1.0, True, torch.device("cpu"))
    r.trace = Trace([], [])
    r.span = dict(t0=t0, t1=t1, units=steps, launches={"dit_rows": rows})
    r.shapes = {"text_valid": [200]}
    return r


def test_embed_ms_reads_one_span_a_step():
    got = read_metric("embed_ms.step", traced(3, 1, 3))
    assert 1.0 <= got < 50.0
    clear_spans()


@pytest.mark.parametrize("embeds,rows,match", [
    (2, 3, "2 dit.embed spans in a step"),
    (1, 6, "6 DiT rows in 3 steps")])
def test_embed_ms_checks_spans_and_rows(embeds, rows, match):
    with pytest.raises(RuntimeError, match=match):
        read_metric("embed_ms.step", traced(3, embeds, rows))
    clear_spans()


def test_embed_ms_is_none_without_the_span():
    assert read_metric("embed_ms.step", traced(3, 0, 3)) is None
    clear_spans()
