"""The port's text-to-video slice as a whole against the JAX pipeline on the
CPU: prompt strings -> both text towers -> 2 CFG flow-match steps of a tiny
DiT -> VAE decode, from the same injected latents and identical weights.
Also `predict` on the CPU for shapes, dtypes and input checks.

fp32 throughout; the float32 video agrees to 1e-4 (relative to its
[0, 1] range) and the uint8 video to one level (a pixel on a rounding
boundary may round the other way).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuanvideo_efficiency_tpu.diffusion.pipeline import (
    HunyuanVideoPipeline as JPipeline)
from hunyuanvideo_efficiency_tpu.diffusion.scheduler import (
    FlowMatchDiscreteScheduler as JScheduler)
from hunyuanvideo_efficiency_tpu.models.dit import init_dit_params
from hunyuanvideo_efficiency_tpu.models.dit_config import DiTConfig as JDiTCfg
from hunyuanvideo_efficiency_tpu.models.text import (
    CLIPTextConfig as JClipCfg, LlamaConfig as JLlamaCfg,
    TextEncoder as JTextEncoder, init_clip_params, init_llama_params)
from hunyuanvideo_efficiency_tpu.models.vae import (
    AutoencoderKLCausal3D as JVAE, init_vae_params)
from hunyuanvideo_efficiency_tpu.models.vae_config import VAEConfig as JVAECfg
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs, parse_args
from hunyuanvideo_efficiency_tpu_torch.diffusion.pipeline import (
    HunyuanVideoPipeline, denoise_step)
from hunyuanvideo_efficiency_tpu_torch.diffusion.scheduler import (
    FlowMatchDiscreteScheduler)
from hunyuanvideo_efficiency_tpu_torch.inference import (HunyuanVideoSampler,
                                                         get_rotary_pos_embed)
from hunyuanvideo_efficiency_tpu_torch.models.dit import HYVideoDiT
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.models.text import (
    CLIPTextConfig, CLIPTextModel, LlamaConfig, LlamaModel, TextEncoder)
from hunyuanvideo_efficiency_tpu_torch.models.vae import AutoencoderKLCausal3D
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import VAEConfig
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    clip_state_dict_from_jax, dit_state_dict_from_jax,
    llama_state_dict_from_jax, vae_state_dict_from_jax)

DIT = dict(hidden_size=128, heads_num=4, mm_double_blocks_depth=1,
           mm_single_blocks_depth=1, rope_dim_list=(8, 12, 12),
           text_states_dim=64, text_states_dim_2=48)
LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2)
CLIP = dict(vocab_size=96, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, eos_token_id=95)
VAE = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1)
TPL = {"template": "instr {} end", "crop_start": 2}
H, W, F = 32, 48, 5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randomize_modulation(tree, rng):
    """Random values for the zero-initialized adaLN and final layers."""
    hot_keys = ("img_mod", "txt_mod", "modulation", "adaLN_modulation",
                "final_layer")

    def walk(node, hot):
        if isinstance(node, dict):
            return {k: walk(v, hot or k in hot_keys) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, hot) for v in node]
        return (rng.standard_normal(node.shape).astype(np.float32) * 0.05
                if hot else node)
    return walk(tree, False)


def jit_init(fn, seed, *args):
    """The JAX initializer's own draw, as a numpy tree."""
    return _np_tree(jax.jit(fn, static_argnums=tuple(range(1, len(args)
                                                             + 1)))(
        jax.random.PRNGKey(seed), *args))


def build_pipelines(init=jit_init, llama=LLAMA, **dit_overrides):
    """(JAX pipeline, port pipeline) of the tiny towers, DiT and VAE, with
    identical random weights drawn by `init(fn, seed, *args)`; `llama`
    is the Llama tower's config; `dit_overrides` go to both DiT configs."""
    jdit_cfg = JDiTCfg(**{"attn_mode": "flash", **DIT, **dit_overrides})
    dit_p = _randomize_modulation(
        init(init_dit_params, 0, jdit_cfg, jnp.float32),
        np.random.default_rng(0))
    llama_p = init(init_llama_params, 1, JLlamaCfg(**llama), jnp.float32)
    clip_p = init(init_clip_params, 2, JClipCfg(**CLIP), jnp.float32)
    vae_p = init(init_vae_params, 3, JVAECfg(**VAE))

    jpipe = JPipeline(
        vae=JVAE(JVAECfg(**VAE), jax.tree.map(jnp.asarray, vae_p)),
        text_encoder=JTextEncoder(
            "llm", 16, params=jax.tree.map(jnp.asarray, llama_p),
            model_config=JLlamaCfg(**llama), prompt_template=TPL,
            prompt_template_video=TPL, hidden_state_skip_layer=1,
            dtype=jnp.float32),
        text_encoder_2=JTextEncoder(
            "clipL", 20, params=jax.tree.map(jnp.asarray, clip_p),
            model_config=JClipCfg(**CLIP), dtype=jnp.float32),
        transformer_params=jax.tree.map(jnp.asarray, dit_p),
        transformer_cfg=jdit_cfg, scheduler=JScheduler(shift=7.0))

    dit = HYVideoDiT(DiTConfig(**DIT, **dit_overrides)).eval()
    dit.load_state_dict(dit_state_dict_from_jax(dit_p, dit.cfg))
    llama_m = LlamaModel(LlamaConfig(**llama)).eval()
    llama_m.load_state_dict(llama_state_dict_from_jax(llama_p))
    clip = CLIPTextModel(CLIPTextConfig(**CLIP)).eval()
    clip.load_state_dict(clip_state_dict_from_jax(clip_p))
    vae = AutoencoderKLCausal3D(VAEConfig(**VAE)).eval()
    vae.load_state_dict(vae_state_dict_from_jax(vae_p))
    tpipe = HunyuanVideoPipeline(
        vae=vae,
        text_encoder=TextEncoder("llm", 16, llama_m, prompt_template=TPL,
                                 prompt_template_video=TPL,
                                 hidden_state_skip_layer=1),
        text_encoder_2=TextEncoder("clipL", 20, clip),
        transformer=dit, scheduler=FlowMatchDiscreteScheduler(shift=7.0))
    return jpipe, tpipe


@pytest.fixture(scope="module")
def pipelines():
    return build_pipelines()


def test_two_step_cfg_pipeline_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    latents = np.random.default_rng(4).standard_normal(
        (1, 16, 2, H // 8, W // 8)).astype(np.float32)
    jfreqs = jax_rope(DIT["rope_dim_list"], (2, 2, 3), theta=256.0)
    tcos, tsin, sizes = get_rotary_pos_embed(tpipe.transformer.cfg,
                                             "884-16c-hy", F, H, W,
                                             device="cpu")
    assert sizes == (2, 2, 3)
    kw = dict(height=H, width=W, video_length=F, num_inference_steps=2,
              guidance_scale=6.0, negative_prompt="blurry, low quality")
    outs = {}
    for dt in ("float32", "uint8"):
        ref = np.asarray(jpipe("a cat walks on grass", **kw,
                               latents=jnp.asarray(latents),
                               freqs_cis=jfreqs, scan_denoise=False,
                               output_dtype=dt).videos)
        out = tpipe("a cat walks on grass", **kw,
                    latents=torch.from_numpy(latents),
                    freqs_cis=(tcos, tsin), output_dtype=dt).videos
        assert out.shape == ref.shape == (1, 3, F, H, W)
        assert str(out.dtype) == f"torch.{dt}"
        outs[dt] = (out.numpy(), ref)
    out, ref = outs["float32"]
    assert ref.std() > 1e-3   # a video, not a constant
    np.testing.assert_allclose(out, ref, atol=1e-4)
    out, ref = outs["uint8"]
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.fixture(scope="module")
def sampler(pipelines):
    _, tpipe = pipelines
    args = InferenceArgs(text_states_dim=64, text_states_dim_2=48,
                         vae_tiling=False, device="cpu")
    return HunyuanVideoSampler(args, tpipe.vae, tpipe.text_encoder,
                               tpipe.text_encoder_2, tpipe.transformer)


def test_predict_on_cpu(sampler):
    out = sampler.predict("a cat", height=30, width=40, video_length=5,
                          seed=42, infer_steps=1, guidance_scale=6.0,
                          output_dtype="uint8")
    assert out["samples"].shape == (1, 3, 5, 32, 48)   # aligned to 16
    assert out["samples"].dtype == torch.uint8
    assert out["seeds"] == [42] and out["size"] == (32, 48, 5)
    again = sampler.predict("a cat", height=30, width=40, video_length=5,
                            seed=42, infer_steps=1, guidance_scale=6.0,
                            output_dtype="uint8")
    assert torch.equal(out["samples"], again["samples"])


def test_predict_rejects_bad_inputs(sampler):
    with pytest.raises(ValueError, match="multiple of 4"):
        sampler.predict("x", 32, 32, video_length=6, infer_steps=1)
    with pytest.raises(TypeError, match="prompt"):
        sampler.predict(123, 32, 32, 5, infer_steps=1)


@pytest.mark.parametrize("flags,match", [
    (dict(ring_degree=2, use_fp8=True, shard_dit_weights=True),
     "--scan-denoise"),
    (dict(ulysses_degree=2, shard_dit_weights=True),
     "--mlp-chunk-tokens 4096"),
    (dict(mesh_shape="dp:2", attn_mode="sta_int8", shard_dit_weights=True),
     "--compile-cache-dir cache"),
], ids=["flags0-weight tiers", "flags1-sequence parallelism",
        "flags2-attn-mode sta"])
def test_unported_flags_rejected(flags, match):
    """Every tier now parses, the sharded-weight tier (--shard-dit-weights)
    with the sequence-parallel flags, the weight tiers and the int8
    attention modes; what stays rejected are the JAX package's flags that
    the port leaves out (ROADMAP §A: TPU/XLA workarounds)."""
    args = InferenceArgs(**flags)
    assert args.shard_dit_weights
    with pytest.raises(SystemExit):
        parse_args(match.split())


def test_from_pretrained_random_and_pt(monkeypatch, tmp_path, pipelines):
    """from_pretrained on the CPU with a tiny registry: random weights, then
    reference-layout .pt checkpoints (deepspeed `module` key, `vae.` prefix)
    that load into the same modules unchanged."""
    from hunyuanvideo_efficiency_tpu_torch import inference

    _, tpipe = pipelines
    monkeypatch.setattr(inference, "load_dit_config",
                        lambda name, **kw: DiTConfig(**DIT, **kw))
    monkeypatch.setattr(inference, "load_vae_config",
                        lambda name: VAEConfig(**VAE))
    towers = dict(llm_config=LlamaConfig(**LLAMA),
                  clip_config=CLIPTextConfig(**CLIP))
    args = InferenceArgs(model="HYVideo-T/2", text_states_dim=64,
                         text_states_dim_2=48, vae_tiling=False, device="cpu",
                         precision="fp32", vae_precision="fp32",
                         text_encoder_precision="fp32",
                         model_base=str(tmp_path))
    with pytest.raises(FileNotFoundError, match="DiT"):
        HunyuanVideoSampler.from_pretrained(args=args, **towers)
    rand = HunyuanVideoSampler.from_pretrained(args=args,
                                               allow_random_init=True,
                                               **towers)
    out = rand.predict("a dog", 32, 32, 5, seed=1, infer_steps=1,
                       output_dtype="float16")
    assert out["samples"].shape == (1, 3, 5, 32, 32)
    assert out["samples"].dtype == torch.float16

    ckpt = tmp_path / "hunyuan-video-t2v-720p"
    (ckpt / "transformers").mkdir(parents=True)
    (ckpt / "vae").mkdir()
    torch.save({"module": tpipe.transformer.state_dict()},
               ckpt / "transformers" / "pytorch_model_module.pt")
    torch.save({f"vae.{k}": v for k, v in tpipe.vae.state_dict().items()},
               ckpt / "vae" / "pytorch_model.pt")
    loaded = HunyuanVideoSampler.from_pretrained(args=args,
                                                 allow_random_init=True,
                                                 **towers)
    for a, b in ((loaded.transformer, tpipe.transformer),
                 (loaded.vae, tpipe.vae)):
        for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
            assert ka == kb and torch.equal(va, vb)


def test_distilled_dit_without_embedded_guidance_raises():
    """A guidance-distilled DiT given no embedded_guidance_scale raises, as
    the published model does, instead of running on guidance 0."""
    dit = HYVideoDiT(DiTConfig(**DIT, guidance_embed=True)).eval()
    cos, sin, _ = get_rotary_pos_embed(dit.cfg, "884-16c-hy", F, H, W,
                                       device="cpu")
    g = torch.Generator().manual_seed(0)
    latents = torch.randn(1, 16, 2, H // 8, W // 8, generator=g)
    pe = torch.randn(1, 6, DIT["text_states_dim"], generator=g)
    pe2 = torch.randn(1, DIT["text_states_dim_2"], generator=g)
    mask = torch.ones(1, 6, dtype=torch.int64)
    args = (dit, latents, 1.0, 0.5, 1000.0, pe, mask, pe2, cos, sin, False,
            1.0)
    with pytest.raises(ValueError, match="guidance"):
        denoise_step(*args, None, 0.0)
    assert denoise_step(*args, 6.0, 0.0).shape == latents.shape
