"""The port's CLI and model loading on the CPU.

* `sample_video.main` end to end on a tiny model tree written to tmp_path:
  DiT and VAE reference-layout `.pt` checkpoints and the text towers in
  either format the loader reads (the JAX package's `.npz` trees written by
  its own saver, or HF state dicts with the `model.` / `text_model.`
  prefixes); the loaded towers equal the written weights bit for bit.
* The full-scale key -> shape maps of the port's modules, on the meta
  device, against the JAX package's reference skeletons
  (`utils/key_coverage.py`): DiT 852, VAE 248, Llama 290, CLIP 196.
* Where loading fails as the JAX package fails, and where it goes on.
* The reference flags `--use-cpu-offload`, `--disable-autocast` and
  `--reproduce`, and the sequential offload giving the same video.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit_config import (
    load_dit_config as jax_dit_config)
from hunyuanvideo_efficiency_tpu.models.text import (
    CLIPTextConfig as JClipCfg, LlamaConfig as JLlamaCfg, init_clip_params,
    init_llama_params)
from hunyuanvideo_efficiency_tpu.models.vae_config import (
    load_vae_config as jax_vae_config)
from hunyuanvideo_efficiency_tpu.utils.checkpoint import save_params_npz
from hunyuanvideo_efficiency_tpu.utils.key_coverage import (
    clip_reference_skeleton, dit_reference_skeleton, llama_reference_skeleton,
    vae_reference_skeleton)
from hunyuanvideo_efficiency_tpu_torch import inference, sample_video
from hunyuanvideo_efficiency_tpu_torch.config import parse_args
from hunyuanvideo_efficiency_tpu_torch.diffusion.pipeline import (
    HunyuanVideoPipeline)
from hunyuanvideo_efficiency_tpu_torch.diffusion.scheduler import (
    FlowMatchDiscreteScheduler)
from hunyuanvideo_efficiency_tpu_torch.inference import (HunyuanVideoSampler,
                                                         get_rotary_pos_embed)
from hunyuanvideo_efficiency_tpu_torch.models.dit import HYVideoDiT
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import (
    DiTConfig, load_dit_config)
from hunyuanvideo_efficiency_tpu_torch.models.text import (
    CLIP_L, LLAMA3_8B, CLIPTextConfig, CLIPTextModel, LlamaConfig, LlamaModel,
    TextEncoder)
from hunyuanvideo_efficiency_tpu_torch.models.text import encoder
from hunyuanvideo_efficiency_tpu_torch.models.vae import AutoencoderKLCausal3D
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
    VAEConfig, load_vae_config)
from hunyuanvideo_efficiency_tpu_torch.utils.checkpoint import tower_keys
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    clip_state_dict_from_jax, llama_state_dict_from_jax)
from test_torch_pipeline import CLIP, DIT, LLAMA, TPL, VAE, F, H, W

CKPT = "hunyuan-video-t2v-720p"


@pytest.fixture
def tiny_registry(monkeypatch):
    """The CLI's names resolve to the tiny configs of test_torch_pipeline."""
    monkeypatch.setattr(inference, "load_dit_config",
                        lambda name, **kw: DiTConfig(**DIT, **kw))
    monkeypatch.setattr(inference, "load_vae_config",
                        lambda name: VAEConfig(**VAE))
    monkeypatch.setattr(encoder, "LLAMA3_8B", LlamaConfig(**LLAMA))
    monkeypatch.setattr(encoder, "CLIP_L", CLIPTextConfig(**CLIP))


def _write_dit_vae(base: Path):
    torch.manual_seed(0)
    dit = HYVideoDiT(DiTConfig(**DIT)).eval()
    vae = AutoencoderKLCausal3D(VAEConfig(**VAE)).eval()
    (base / CKPT / "transformers").mkdir(parents=True)
    (base / CKPT / "vae").mkdir()
    torch.save({"module": dit.state_dict()},
               base / CKPT / "transformers" / "pytorch_model_module.pt")
    torch.save({f"vae.{k}": v for k, v in vae.state_dict().items()},
               base / CKPT / "vae" / "pytorch_model.pt")


def _jax_towers():
    """JAX parameter trees of the tiny towers (numpy leaves)."""
    llama = jax.jit(init_llama_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(1), JLlamaCfg(**LLAMA), jnp.float32)
    clip = jax.jit(init_clip_params, static_argnums=(1, 2))(
        jax.random.PRNGKey(2), JClipCfg(**CLIP), jnp.float32)
    return jax.tree.map(np.asarray, llama), jax.tree.map(np.asarray, clip)


def _write_towers(base: Path, fmt: str):
    """Tower files in `fmt` ("npz": the JAX saver's trees; "pt": HF state
    dicts with prefixes, the LM head and CLIP's position_ids buffer).
    Returns the port state dicts they must load as."""
    llama_p, clip_p = _jax_towers()
    want = (llama_state_dict_from_jax(llama_p),
            clip_state_dict_from_jax(clip_p))
    if fmt == "npz":
        save_params_npz(str(base / "text_encoder.npz"), llama_p)
        save_params_npz(str(base / "text_encoder_2.npz"), clip_p)
        return want
    (base / "text_encoder").mkdir()
    (base / "text_encoder_2").mkdir()
    llm_sd = {f"model.{k}": v for k, v in want[0].items()}
    llm_sd["lm_head.weight"] = torch.zeros(LLAMA["vocab_size"],
                                           LLAMA["hidden_size"])
    clip_sd = {f"text_model.{k}": v for k, v in want[1].items()}
    clip_sd["text_model.embeddings.position_ids"] = torch.arange(
        CLIP["max_position_embeddings"])[None]
    torch.save(llm_sd, base / "text_encoder" / "pytorch_model.pt")
    torch.save(clip_sd, base / "text_encoder_2" / "pytorch_model.pt")
    return want


def _argv(base: Path, *extra):
    return ["--model-base", str(base), "--model", "HYVideo-T/2",
            "--device", "cpu", "--precision", "fp32", "--vae-precision",
            "fp32", "--text-encoder-precision", "fp32",
            "--text-encoder-precision-2", "fp32", "--text-len", "16",
            "--text-states-dim", "64", "--text-states-dim-2", "48",
            "--video-size", "32", "48", "--video-length", "5",
            "--infer-steps", "1", "--seed", "1", "--prompt", "a cat walks",
            "--no-vae-tiling", "--save-path", str(base / "out"), *extra]


@pytest.mark.parametrize("fmt,extra", [("npz", ("--use-cpu-offload",)),
                                       ("pt", ())], ids=["npz", "pt"])
def test_sample_video_main_on_a_model_tree(tiny_registry, monkeypatch,
                                           tmp_path, fmt, extra):
    """The CLI writes an mp4 from a tree of DiT, VAE and tower files,
    without random weights anywhere; the towers are the written ones."""
    _write_dit_vae(tmp_path)
    want_llm, want_clip = _write_towers(tmp_path, fmt)
    made = []

    class Spy(HunyuanVideoSampler):
        @classmethod
        def from_pretrained(cls, *a, **kw):
            assert not kw.get("allow_random_init")
            made.append(super().from_pretrained(*a, **kw))
            return made[-1]

    monkeypatch.setattr(sample_video, "HunyuanVideoSampler", Spy)
    paths = sample_video.main(_argv(tmp_path, *extra))
    assert len(paths) == 1 and Path(paths[0]).stat().st_size > 0
    assert paths[0].endswith(".mp4")
    sampler = made[0]
    for model, want in ((sampler.text_encoder.model, want_llm),
                        (sampler.text_encoder_2.model, want_clip)):
        got = model.state_dict()
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_model_tree_failures(tiny_registry, tmp_path):
    """As the JAX package: no towers and no `text_encoder/` raises unless
    random weights are allowed; an existing `text_encoder/` without
    weights gives random towers; so does only one tower file."""
    _write_dit_vae(tmp_path)
    args = parse_args(_argv(tmp_path))
    with pytest.raises(FileNotFoundError, match="No text encoder"):
        HunyuanVideoSampler.from_pretrained(args=args)
    HunyuanVideoSampler.from_pretrained(args=args, allow_random_init=True)
    llama_p, _ = _jax_towers()
    save_params_npz(str(tmp_path / "text_encoder.npz"), llama_p)
    HunyuanVideoSampler.from_pretrained(args=args)
    (tmp_path / "text_encoder.npz").unlink()
    (tmp_path / "text_encoder").mkdir()
    HunyuanVideoSampler.from_pretrained(args=args)


def _shapes(sd):
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name,count", [("dit", 852), ("vae", 248),
                                        ("llama", 290), ("clip", 196)])
def test_full_scale_keys_match_reference(name, count):
    """The port's modules at full scale (meta device) carry the reference
    checkpoints' names and shapes; the tower loader's key mapping turns
    the HF checkpoints (LlamaForCausalLM with `model.` and the LM head,
    CLIPTextModel with `text_model.` and `position_ids`) into them."""
    with torch.device("meta"):
        if name == "dit":
            port = HYVideoDiT(load_dit_config("HYVideo-T/2"))
            ref = dit_reference_skeleton(jax_dit_config("HYVideo-T/2"))
        elif name == "vae":
            port = AutoencoderKLCausal3D(load_vae_config("884-16c-hy"))
            ref = vae_reference_skeleton(jax_vae_config("884-16c-hy"))
        elif name == "llama":
            port = LlamaModel(LLAMA3_8B)
            ref = tower_keys(llama_reference_skeleton(JLlamaCfg()), "llm")
        else:
            port = CLIPTextModel(CLIP_L)
            ref = tower_keys(clip_reference_skeleton(JClipCfg()), "clipL")
    assert len(ref) == count
    assert _shapes(port.state_dict()) == _shapes(ref)


@pytest.mark.parametrize("flag", ["use-cpu-offload", "disable-autocast",
                                  "reproduce"])
def test_reference_flags_parse(flag):
    dest = flag.replace("-", "_")
    assert getattr(parse_args([]), dest) is False
    assert getattr(parse_args([f"--{flag}"]), dest) is True
    assert getattr(parse_args([f"--no-{flag}"]), dest) is False
    with pytest.raises(SystemExit):
        parse_args([f"--{flag}", f"--no-{flag}"])


def test_cpu_offload_gives_the_same_video(monkeypatch):
    """A tiny 2-step CFG pipeline (random port modules) with cpu_offload
    equals the one without, bit for bit. The device is "cpu:0" here, so that moves to it are told
    apart from moves to the host ("cpu"): in each phase every other phase's
    modules go to the host first, then the phase's own to the device, in
    the order towers -> DiT -> VAE."""
    torch.manual_seed(0)   # the modules' default random init
    tpipe = HunyuanVideoPipeline(
        vae=AutoencoderKLCausal3D(VAEConfig(**VAE)).eval(),
        text_encoder=TextEncoder(
            "llm", 16, LlamaModel(LlamaConfig(**LLAMA)).eval(),
            prompt_template=TPL, prompt_template_video=TPL,
            hidden_state_skip_layer=1),
        text_encoder_2=TextEncoder(
            "clipL", 20, CLIPTextModel(CLIPTextConfig(**CLIP)).eval()),
        transformer=HYVideoDiT(DiTConfig(**DIT)).eval(),
        scheduler=FlowMatchDiscreteScheduler(shift=7.0))
    latents = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 16, 2, H // 8, W // 8)).astype(np.float32))
    cos, sin, _ = get_rotary_pos_embed(tpipe.transformer.cfg, "884-16c-hy",
                                       F, H, W, device="cpu")
    kw = dict(height=H, width=W, video_length=F, num_inference_steps=2,
              guidance_scale=6.0, negative_prompt="blurry",
              latents=latents, freqs_cis=(cos, sin))
    ref = tpipe("a cat walks on grass", **kw).videos
    off = HunyuanVideoPipeline(
        vae=tpipe.vae, text_encoder=tpipe.text_encoder,
        text_encoder_2=tpipe.text_encoder_2, transformer=tpipe.transformer,
        scheduler=FlowMatchDiscreteScheduler(shift=7.0), cpu_offload=True,
        device=torch.device("cpu", 0))

    moves, phases = [], []
    module_to, place = torch.nn.Module.to, HunyuanVideoPipeline._place

    def spy_to(self, *a, **k):
        moves.append((type(self).__name__, str(a[0])))
        return module_to(self, *a, **k)

    def spy_place(self, phase):
        moves.clear()
        place(self, phase)
        phases.append((phase, list(moves)))

    monkeypatch.setattr(torch.nn.Module, "to", spy_to)
    monkeypatch.setattr(HunyuanVideoPipeline, "_place", spy_place)
    out = off("a cat walks on grass", **kw).videos
    assert ref.std() > 1e-3   # a video, not a constant
    assert torch.equal(out, ref)
    own = {"text": {"LlamaModel", "CLIPTextModel"}, "dit": {"HYVideoDiT"},
           "vae": {"AutoencoderKLCausal3D"}}
    assert [p for p, _ in phases] == ["text", "dit", "vae"]
    for phase, mv in phases:
        to_dev = [n for n, d in mv if d == "cpu:0"]
        to_host = [n for n, d in mv if d == "cpu"]
        assert set(to_dev) == own[phase]
        assert set(to_host) == set().union(
            *(v for k, v in own.items() if k != phase))
        assert mv[:len(to_host)] == [(n, "cpu") for n in to_host]
