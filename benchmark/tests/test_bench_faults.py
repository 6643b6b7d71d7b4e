"""A run with the timed path broken underneath reads `correct` false,
once for each fault the cells can have (one card, so no exchange between
chips): a step that returns its state unchanged, half of the CFG batch
left out, an answer altered where it is produced; and the controls, the
nearest precision below the configuration's in the program's place, read
at least three times the sound runs. On the CPU at a tiny size, the
chip's look skipped; the limit is set between the sound and the broken
readings of this size."""
import pytest
import torch

from hunyuanvideo_efficiency_tpu_torch.diffusion import pipeline
from hunyuanvideo_efficiency_tpu_torch.models import dit as dit_mod
from hunyuanvideo_efficiency_tpu_torch.models import vae as vae_mod

from . import tiny_runs

T2V_LIMIT = {"v_rel_l2": {"limit": 0.03}}
VAE_LIMIT = {"recon_rel_l2": {"limit": 0.012},
             "metric_gap": {"limit": 1e-9}, "lpips_gap": {"limit": 1e-4}}


@pytest.mark.parametrize("cfg", ["tiny-bf16.json", "tiny-sta-int8.json"])
def test_sound_run_is_correct(cfg):
    assert tiny_runs.run(cfg, "tiny-t2v.json", lim=T2V_LIMIT)["correct"]


def test_sound_vae_run_is_correct():
    assert tiny_runs.run("tiny-bf16.json", "tiny-vae.json", seconds=0.3,
                         lim=VAE_LIMIT)["correct"]


def unchanged_state(monkeypatch):
    monkeypatch.setattr(pipeline, "euler_step",
                        lambda sample, v, s, s_next: sample.float())


def half_batch(monkeypatch):
    """The DiT runs the conditional half only and serves it for both."""
    orig = dit_mod.HYVideoDiT.forward

    def forward(self, x, t, ts, tm, ts2, *rest, **kw):
        half = orig(self, x[1:], t[1:], ts[1:], tm[1:], ts2[1:], *rest,
                    **kw)
        return torch.cat([half, half])

    monkeypatch.setattr(dit_mod.HYVideoDiT, "forward", forward)


def altered_answer(monkeypatch):
    orig = pipeline.euler_step

    def step(sample, v, s, s_next):
        out = orig(sample, v, s, s_next)
        out.view(-1)[7] += 0.5
        return out

    monkeypatch.setattr(pipeline, "euler_step", step)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_answer])
@pytest.mark.parametrize("cfg", ["tiny-bf16.json", "tiny-sta-int8.json"])
def test_t2v_fault_is_not_correct(fault, cfg, monkeypatch):
    fault(monkeypatch)
    r = tiny_runs.run(cfg, "tiny-t2v.json", lim=T2V_LIMIT)
    assert r["correct"] is False, r["checks"]


def vae_unchanged(monkeypatch):
    monkeypatch.setattr(vae_mod.AutoencoderKLCausal3D, "forward",
                        lambda self, x, **kw: x.to(self.dtype))


def vae_altered(monkeypatch):
    orig = vae_mod.AutoencoderKLCausal3D.forward

    def forward(self, x, **kw):
        out = orig(self, x, **kw)
        return out + 0.05 * (out.flatten()[0] == out.flatten()[0])

    monkeypatch.setattr(vae_mod.AutoencoderKLCausal3D, "forward", forward)


@pytest.mark.parametrize("fault", [vae_unchanged, vae_altered])
def test_vae_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    r = tiny_runs.run("tiny-bf16.json", "tiny-vae.json", seconds=0.3,
                      lim=VAE_LIMIT)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cfg", ["tiny-bf16.json", "tiny-sta-int8.json"])
def test_t2v_control_fails(cfg):
    """The reference in the control's tiers (fp8 for bf16, int4 for the
    int8 tiers) in the program's place."""
    from benchmark.control import t2v_reference_control
    from benchmark.run import Run

    sound = tiny_runs.run(cfg, "tiny-t2v.json")
    run = Run("tiny", tiny_runs.load(cfg), tiny_runs.load("tiny-t2v.json"),
              5, 0.05, False, torch.device("cpu"))
    got = t2v_reference_control(run)["v_rel_l2"]
    assert got >= 3 * sound["checks"]["v_rel_l2"]["value"]
    assert got > T2V_LIMIT["v_rel_l2"]["limit"]


def test_vae_control_reference_fails():
    """The reference VAE with bf16 operands (the configuration's
    `vae_reference_tier`, the nearest below its fp16), float32 PSNR/SSIM
    and bfloat16 LPIPS in the program's place."""
    from benchmark.control import vae_reference_control
    from benchmark.run import Run

    sound = tiny_runs.run("tiny-bf16.json", "tiny-vae.json", seconds=0.3)
    cfg, traffic = (tiny_runs.load(n) for n in ("tiny-bf16.json",
                                                "tiny-vae.json"))
    run = Run("tiny", cfg, traffic, 5, 0.05, False, torch.device("cpu"))
    got = vae_reference_control(run)
    for k in ("recon_rel_l2", "metric_gap", "lpips_gap"):
        assert got[k] >= 3 * sound["checks"][k]["value"], (k, got, sound)
    assert got["recon_rel_l2"] > VAE_LIMIT["recon_rel_l2"]["limit"]
