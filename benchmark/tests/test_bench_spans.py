"""The span readers (benchmark/spans.py and the metrics that read the
program's spans): each returns a finite value on a tiny traced run through
run.execute on the CPU, and raises when one site skips its span; the idle
readers, on a synthetic trace and span log, put each idle gap in the span
the host was in and leave out the profiler's own buffer flushes."""
import contextlib
import itertools
import json
import math
import random
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import spans as bench_spans
from benchmark.drivers import t2v, vae_tops
from benchmark.run import Run, execute, read_metric
from benchmark.trace import Trace
from hunyuanvideo_efficiency_tpu_torch.diffusion import pipeline
from hunyuanvideo_efficiency_tpu_torch.evaluation import metrics as ev_metrics
from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod
from hunyuanvideo_efficiency_tpu_torch.models import vae as vae_mod
from hunyuanvideo_efficiency_tpu_torch.ops import conv3d
from hunyuanvideo_efficiency_tpu_torch.utils import profiling

from . import tiny_runs
from .test_bench_window import FakeTime

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"]
                if m["source"] == "program_span"}
T2V = [n for n, m in SPAN_METRICS.items() if m["moves"] == "step_s"]
VAE = [n for n, m in SPAN_METRICS.items() if m["moves"] == "roundtrip_s"]
LOOSE = {"v_rel_l2": {"limit": 1.0}, "recon_rel_l2": {"limit": 1.0},
         "metric_gap": {"limit": 1.0}, "lpips_gap": {"limit": 1.0}}


@pytest.fixture(autouse=True)
def empty_log():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def traced(cfg_name, traffic_name, metrics, seconds):
    """A tiny traced run of `metrics` on the CPU on a fake clock (3 steps,
    or 8 round trips: two a t-ops config)."""
    cfg, traffic = tiny_runs.load(cfg_name), tiny_runs.load(traffic_name)
    w = {"name": "tiny", "config": cfg["name"], "traffic": "tiny",
         "chips": 1}
    bench = {"end_to_end": [],
             "per_layer": [{k: v for k, v in SPAN_METRICS[n].items()
                            if k != "workloads"} for n in metrics]}
    return execute(bench, w, cfg, traffic, 5, seconds, True,
                   torch.device("cpu"), lim=LOOSE)


@pytest.fixture
def fake_clock(monkeypatch):
    monkeypatch.setattr(t2v, "time", FakeTime())
    monkeypatch.setattr(vae_tops, "time", FakeTime())


@pytest.mark.parametrize("cfg", ["tiny-bf16.json", "tiny-sta-int8.json"])
def test_t2v_span_readers_read_a_traced_run(fake_clock, cfg):
    r = traced(cfg, "tiny-t2v.json", T2V, seconds=5)
    assert r["attempted"] == 3
    assert set(r["metrics"]) == set(T2V)
    for name in T2V:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)


def test_vae_span_readers_read_a_traced_run(fake_clock):
    r = traced("tiny-bf16.json", "tiny-vae.json", VAE, seconds=37)
    assert r["attempted"] == 8
    assert set(r["metrics"]) == set(VAE)
    for name in VAE:
        v = r["metrics"][name]["value"]
        assert math.isfinite(v) and v >= 0, (name, v)
    for name in ("vae_pad_ms.roundtrip", "vae_norm_ms.roundtrip"):
        assert r["metrics"][name]["value"] > 0


def skip_once(monkeypatch, module, name, index):
    """`module`'s span skips the `index`-th site of `name` recorded under
    the profiler."""
    real = profiling.span
    seen = itertools.count()

    def span(x):
        if x == name and torch.autograd._profiler_enabled() \
                and next(seen) == index:
            return contextlib.nullcontext()
        return real(x)

    monkeypatch.setattr(module, "span", span)


# (metric, the module holding the span's site, the span, which recorded
# site to skip: one of the window's second step, of a tiny 2+2-block
# forward's 21 adaLN, 4 QK-norm and 4 attention sites, or any)
SKIPS = [("qk_rope_ms.step", dit_mod, "dit.qk_rope", 4),
         ("adaln_ms.step", dit_mod, "dit.adaln", 21),
         ("attn_layout_ms.step", dit_mod, "dit.attention", 4),
         ("text_encode_ms.predict", pipeline, "text_encode", 0),
         ("vae_pad_ms.roundtrip", conv3d, "vae.pad", 3),
         ("vae_norm_ms.roundtrip", vae_mod, "vae.norm_act", 3),
         ("vae_idle_ms.roundtrip", vae_mod, "vae.decoder", 5),
         ("score_idle_ms.roundtrip", ev_metrics, "score.ssim", 2)]


@pytest.mark.parametrize("metric,module,name,index", SKIPS,
                         ids=[s[0] for s in SKIPS])
def test_a_skipped_span_is_refused(fake_clock, monkeypatch, metric, module,
                                   name, index):
    skip_once(monkeypatch, module, name, index)
    vae = metric in VAE
    with pytest.raises(RuntimeError, match=metric):
        traced("tiny-bf16.json", "tiny-vae.json" if vae else "tiny-t2v.json",
               [metric], seconds=37 if vae else 5)


def rec(name, start, end, parent=None):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end,
                           parent=parent, device_ms=(end - start) / 1e6,
                           self_device_ms=None)


class FakeProgram:
    """A span log of two round trips as the program would record it."""

    def __init__(self, recs):
        self.recs = sorted(recs, key=lambda r: r.start_ns)

    def spans(self, t0, t1, name=None):
        return [r for r in self.recs if t0 <= r.start_ns < t1
                and (name is None or r.name == name)]

    def span_at(self, t):
        open_ = [r for r in self.recs if r.start_ns <= t < r.end_ns]
        return max(open_, key=lambda r: r.start_ns) if open_ else None


def synthetic_run(monkeypatch):
    """Round trips [0, 200) and [200, 400), each a VAE part of 100 ns and
    its scores. Trip 1: the host in vae.pad (gap 10-12), in vae.encoder
    (30-40, the profiler flushing its buffers then), outside any span
    (95-100); in score.psnr (120-124), score.lpips (160-170), between
    scores (150-152). Trip 2: in vae.decoder (260-266), in score.ssim
    (340-345)."""
    recs = []
    for base in (0, 200):
        enc = rec("vae.encoder", base, base + 50)
        recs += [enc, rec("vae.pad", base + 5, base + 25, enc),
                 rec("vae.decoder", base + 50, base + 95),
                 rec("score.psnr", base + 110, base + 130),
                 rec("score.ssim", base + 130, base + 150),
                 rec("score.lpips", base + 152, base + 190)]
    ops = [("k", 0, 10), ("k", 12, 30), ("k", 40, 95), ("k", 100, 120),
           ("k", 124, 150), ("k", 152, 160), ("k", 170, 200),
           ("k", 200, 260), ("k", 266, 300), ("k", 300, 340),
           ("k", 345, 400)]
    host = [("cudaLaunchKernel", 8, 9), (bench_spans.TRACER, 31, 39),
            ("cudaLaunchKernel", 33, 34), ("cudaLaunchKernel", 262, 263),
            ("cudaStreamSynchronize", 150, 151)]
    run = Run("x", {}, {}, 1, 1.0, True, torch.device("cpu"))
    run.trace = Trace(ops, sorted(host, key=lambda h: h[1]))
    run.span = dict(t0=0, t1=400, units=2, launches={},
                    vae_parts=[(0, 100), (200, 300)], score_s=0.0)
    run.shapes = {"trips": ["base", "base"]}
    monkeypatch.setattr(bench_spans, "program",
                        lambda: FakeProgram(recs))
    return run


def test_idle_readers_place_each_gap(monkeypatch):
    run = synthetic_run(monkeypatch)
    # VAE: 10-12 (in vae.pad, under vae.encoder) and 260-266 (vae.decoder);
    # 30-40 is the tracer's, 95-100 in no span
    assert read_metric("vae_idle_ms.roundtrip", run) == \
        pytest.approx((2 + 6) / 1e6 / 2)
    # scores: 120-124, 160-170, 340-345; 150-152 lies between two scores
    assert read_metric("score_idle_ms.roundtrip", run) == \
        pytest.approx((4 + 10 + 5) / 1e6 / 2)
    assert read_metric("vae_pad_ms.roundtrip", run) == \
        pytest.approx(20 / 1e6)


def test_the_tracer_test_agrees_with_host_op_at():
    rng = random.Random(7)
    host = []
    for _ in range(200):
        s = rng.randrange(10_000)
        host.append((rng.choice(["cudaLaunchKernel", "cudaMemcpyAsync",
                                 bench_spans.TRACER]), s,
                     s + rng.randrange(1, 60)))
    trace = Trace([], sorted(host, key=lambda h: h[1]))
    at = bench_spans.in_host_op(trace, bench_spans.TRACER)
    for t in range(0, 10_100, 7):
        assert at(t) == (trace.host_op_at(t) == bench_spans.TRACER), t


def test_a_checkout_without_spans_reads_nothing(monkeypatch):
    run = synthetic_run(monkeypatch)
    monkeypatch.setattr(bench_spans, "program", lambda: None)
    run.cfg = {"dit": {"mm_double_blocks_depth": 2,
                       "mm_single_blocks_depth": 2}}
    for name in SPAN_METRICS:
        assert read_metric(name, run) is None
