"""The per-layer readers' plumbing: each metric file names the program's
kernel wrappers whose launch counters it reads, the run collects exactly
those, the VAE's readers split a round trip at its synchronized
reconstruction, and a configuration key that the t2v driver does not pass
to the program is refused."""
import copy
import json
import re
from pathlib import Path

import pytest
import torch

from benchmark.drivers import t2v
from benchmark.reference import dit as ref_dit
from benchmark.run import Run, metric_module, read_metric
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CONFIGS = {c["name"]: json.loads((ROOT / c["file"]).read_text())
           for c in BENCH["configs"]}


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_launches_read_are_declared(m):
    src = (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").read_text()
    read = set(re.findall(r'span\["launches"\]\["(\w+)"\]', src))
    counters = getattr(metric_module(m["name"]), "COUNTERS", {})
    assert read == set(counters)
    for where in counters.values():
        mod, attr = where.split(":")
        f = getattr(__import__(mod, fromlist=[attr]), attr)
        assert isinstance(f.LAUNCHES, int)


def test_run_reads_the_counters_its_metrics_name():
    run = Run("x", {}, {}, 1, 1.0, False, torch.device("cpu"))
    assert run.read_counts() == {}
    run.metrics = ["k1_roofline", "k3_roofline", "glue_ms.step"]
    assert set(run.read_counts()) == {"flash_static", "conv3d_stride1"}


def test_vae_readers_split_the_round_trip():
    """Two round trips, each a VAE part [0, 10) / [20, 30) and a score
    part: only the VAE parts' glue counts; the scores' host time is the
    span's."""
    ops = [("elementwise_kernel", 1, 4), ("conv3d_s1_kernel", 4, 9),
           ("elementwise_kernel", 12, 18),          # the scores
           ("elementwise_kernel", 21, 23), ("reduce_kernel", 24, 26),
           ("elementwise_kernel", 31, 39)]          # the scores
    run = Run("x", {}, {}, 1, 1.0, True, torch.device("cpu"))
    run.trace = Trace(ops, [])
    run.span = dict(t0=0, t1=40, units=2, launches={},
                    vae_parts=[(0, 10), (20, 30)], score_s=0.0105)
    assert read_metric("vae_glue_ms.roundtrip", run) == \
        pytest.approx(1e3 * (3 + 2 + 2) / 1e9 / 2)
    assert read_metric("score_ms.roundtrip", run) == pytest.approx(10.5)
    assert read_metric("device_idle.roundtrip", run) == \
        pytest.approx(100.0 * (1 - (3 + 5 + 6 + 2 + 2 + 8) / 40))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_pass_the_key_check(name):
    t2v.check_keys(CONFIGS[name])


@pytest.mark.parametrize("where", ["", "text", "sta"])
def test_an_unknown_config_key_is_refused(where):
    cfg = copy.deepcopy(CONFIGS["hyvideo-t2-sta-int8"])
    (cfg[where] if where else cfg)["use_fp16_accumulation"] = True
    with pytest.raises(KeyError, match="use_fp16_accumulation"):
        t2v.check_keys(cfg)


@pytest.mark.parametrize("flag", ["use_fp8", "use_int4_modulation"])
def test_reference_refuses_tiers_it_does_not_model(flag):
    cfg = dict(CONFIGS["hyvideo-t2-bf16"], **{flag: True})
    t2v.check_keys(cfg)
    with pytest.raises(NotImplementedError, match=flag):
        ref_dit.tiers(cfg)
