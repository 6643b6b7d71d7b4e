"""The plain reference against the program, both in float32 on the CPU at
a tiny size: what is left is the order of float32 sums (and, under int8,
a rare code that rounds the other way), so every layer the checks cover is
the same function on both sides."""
import pytest

from . import tiny_runs


def test_dense_t2v_step_matches_the_program():
    r = tiny_runs.run("tiny-bf16.json", "tiny-t2v.json", precision="fp32")
    assert r["checks"]["v_rel_l2"]["value"] < 1e-4


def test_sta_int8_t2v_step_matches_the_program():
    """W8A8 linears and int8 tile codes: the best of three seeds, since a
    code that rounds the other way moves a tiny model by ~1e-3."""
    vals = [tiny_runs.run("tiny-sta-int8.json", "tiny-t2v.json", seed=s,
                          precision="fp32")["checks"]["v_rel_l2"]["value"]
            for s in (1, 2, 3)]
    assert min(vals) < 1e-4, vals


def test_vae_roundtrips_and_scores_match_the_program():
    r = tiny_runs.run("tiny-bf16.json", "tiny-vae.json", seconds=0.5,
                      precision="fp32")
    assert r["checks"]["recon_rel_l2"]["value"] < 1e-4
    assert r["checks"]["metric_gap"]["value"] < 1e-9
    assert r["checks"]["lpips_gap"]["value"] < 1e-5


@pytest.mark.parametrize("cfg", ["tiny-bf16.json", "tiny-sta-int8.json"])
def test_result_line(cfg):
    lim = {"v_rel_l2": {"limit": 1.0}}
    r = tiny_runs.run(cfg, "tiny-t2v.json", lim=lim)
    assert r["correct"] is True
    assert list(r)[-1] == "checks"
    assert set(r["metrics"]) == {"step_s", "setup_s"}
    assert r["attempted"] >= 1 and r["failed"] == 0
