"""The window arithmetic of `step_s` and `roundtrip_s` on a fake clock: the
drivers' `time.perf_counter` advances by 1, 2, 3, ... at each read, so
that the window's length and the work in it are known exactly. A run's
metric is the whole window over all the work completed in it, the window
closing after the step in flight (t2v) or after a whole cycle of the t-ops
configs (vae)."""
import pytest

from benchmark.drivers import t2v, vae_tops

from . import tiny_runs


class FakeTime:
    """perf_counter() reads 0, 1, 3, 6, 10, ...: the k-th read is
    k(k+1)/2."""

    def __init__(self):
        self.k = -1

    def perf_counter(self):
        self.k += 1
        return self.k * (self.k + 1) / 2


@pytest.mark.parametrize("seconds,steps", [(5, 3), (6, 3), (6.5, 4)])
def test_step_s_is_the_window_over_its_steps(monkeypatch, seconds, steps):
    """The window's start reads 0, step i's end (i+1)(i+2)/2; the window
    closes at the first step end at or past `seconds`."""
    monkeypatch.setattr(t2v, "time", FakeTime())
    r = tiny_runs.run("tiny-bf16.json", "tiny-t2v.json", seconds=seconds,
                      lim={"v_rel_l2": {"limit": 1.0}})
    assert r["attempted"] == steps
    end = steps * (steps + 1) / 2
    assert r["metrics"]["step_s"]["value"] == pytest.approx(end / steps)


@pytest.mark.parametrize("seconds,trips", [(5, 4), (36, 4), (37, 8)])
def test_roundtrip_s_is_the_window_over_whole_cycles(monkeypatch, seconds,
                                                     trips):
    """Each round trip reads the clock twice (its VAE's end, its scores'
    end): trip j ends at read 2(j+1), at (2j+2)(2j+3)/2; the window closes
    after the first whole cycle of the 4 configs ending at or past
    `seconds`."""
    monkeypatch.setattr(vae_tops, "time", FakeTime())
    r = tiny_runs.run("tiny-bf16.json", "tiny-vae.json", seconds=seconds,
                      lim={"recon_rel_l2": {"limit": 1.0},
                           "metric_gap": {"limit": 1.0},
                           "lpips_gap": {"limit": 1.0}})
    assert r["attempted"] == trips
    k = 2 * trips
    assert r["metrics"]["roundtrip_s"]["value"] == \
        pytest.approx(k * (k + 1) / 2 / trips)
