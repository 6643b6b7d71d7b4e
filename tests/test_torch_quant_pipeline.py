"""The quantized serving path of the port as a whole against the JAX
package on the CPU: a 2-step CFG pipeline with --use-int8 --attn-mode
flash_int8 --text-encoder-quant int8 from the same injected latents and
carried-over weights (tests/test_torch_pipeline.py's tiny towers, DiT and
VAE); the tier flags through InferenceArgs and the CLI parser; and
from_pretrained applying the tiers and reading a reference fp8 checkpoint
with its scale map.

Tolerance of the video: 2e-3. The int8 codes and sums agree, but an fp32
rounding difference may move one activation to the neighbouring int8 code
(1.6e-3 in the video seen over other prompts' tokens; int8 weights move
the video by 3.2e-3).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.text import encoder as jax_encoder
from hunyuanvideo_efficiency_tpu.models.text.llama import (
    quantize_llama_params_int8)
from hunyuanvideo_efficiency_tpu.ops import quantization as jq
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu_torch import inference
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs, parse_args
from hunyuanvideo_efficiency_tpu_torch.inference import (HunyuanVideoSampler,
                                                         get_rotary_pos_embed)
from hunyuanvideo_efficiency_tpu_torch.models.dit import HYVideoDiT
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.models.text import (CLIPTextConfig,
                                                           LlamaConfig)
from hunyuanvideo_efficiency_tpu_torch.models.text import (
    encoder as torch_encoder)
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import VAEConfig
from hunyuanvideo_efficiency_tpu_torch.ops import quantization as q
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_int8_static)
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import w8a8_linear
from hunyuanvideo_efficiency_tpu_torch.utils.checkpoint import fp8_map_path
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    dit_state_dict_from_jax, llama_state_dict_from_jax)
from test_torch_pipeline import (CLIP, DIT, LLAMA, VAE, F, H, W,
                                 build_pipelines)

INT8_TOL = 2e-3


def test_int8_pipeline_matches_jax(monkeypatch):
    """2 CFG steps of the tiny pipeline with an int8 DiT under flash_int8
    and an int8 LLM tower, from the same latents: the float32 video to
    2e-3. Both HashTokenizers hash words with crc32 here, not the
    per-process salted `hash`, so the token ids (and with them the one int8
    code that an fp32 rounding difference may flip, up to 1.6e-3 in the
    video over other tokens) are the same in every run."""
    for mod in (jax_encoder, torch_encoder):
        monkeypatch.setattr(mod, "hash", lambda w: zlib.crc32(w.encode()),
                            raising=False)
    jpipe, tpipe = build_pipelines(attn_mode="flash_int8")
    jpipe.transformer_params = jq.quantize_dit_params_int8(
        jpipe.transformer_params)
    q.quantize_dit(tpipe.transformer, int8=True)
    tpipe.transformer.load_state_dict(dit_state_dict_from_jax(
        jax.tree.map(np.asarray, jpipe.transformer_params),
        tpipe.transformer.cfg))
    jpipe.text_encoder.params = quantize_llama_params_int8(
        jpipe.text_encoder.params)
    llm = q.quantize_llama_int8(tpipe.text_encoder.model)
    llm.load_state_dict(llama_state_dict_from_jax(
        jax.tree.map(np.asarray, jpipe.text_encoder.params)))
    latents = np.random.default_rng(6).standard_normal(
        (1, 16, 2, H // 8, W // 8)).astype(np.float32)
    jfreqs = jax_rope(DIT["rope_dim_list"], (2, 2, 3), theta=256.0)
    tcos, tsin, _ = get_rotary_pos_embed(tpipe.transformer.cfg, "884-16c-hy",
                                         F, H, W, device="cpu")
    kw = dict(height=H, width=W, video_length=F, num_inference_steps=2,
              guidance_scale=6.0, negative_prompt="blurry, low quality",
              output_dtype="float32")
    ref = np.asarray(jpipe("a cat walks on grass", **kw,
                           latents=jnp.asarray(latents), freqs_cis=jfreqs,
                           scan_denoise=False).videos)
    out = tpipe("a cat walks on grass", **kw,
                latents=torch.from_numpy(latents),
                freqs_cis=(tcos, tsin)).videos
    assert out.shape == ref.shape == (1, 3, F, H, W)
    assert ref.std() > 1e-3
    np.testing.assert_allclose(out.numpy(), ref, atol=INT8_TOL)


def test_tier_flags_parse():
    args = parse_args(["--use-fp8", "--use-int8", "--use-int4-modulation",
                       "--text-encoder-quant", "int8", "--attn-mode",
                       "sta_int8"])
    assert (args.use_fp8, args.use_int8, args.use_int4_modulation,
            args.text_encoder_quant, args.attn_mode) == (
                True, True, True, "int8", "sta_int8")
    assert parse_args(["--attn-mode", "flash_int8"]).attn_mode == "flash_int8"
    with pytest.raises(ValueError, match="int8"):
        InferenceArgs(text_encoder_quant="int4")
    InferenceArgs(ulysses_degree=2, use_int8=True)
    # the sharded-weight tier now parses beside the weight tiers
    assert InferenceArgs(ulysses_degree=2, use_int8=True,
                         shard_dit_weights=True).shard_dit_weights


def _tiny_registry(monkeypatch):
    monkeypatch.setattr(inference, "load_dit_config",
                        lambda name, **kw: DiTConfig(**DIT, **kw))
    monkeypatch.setattr(inference, "load_vae_config",
                        lambda name: VAEConfig(**VAE))
    return dict(llm_config=LlamaConfig(**LLAMA),
                clip_config=CLIPTextConfig(**CLIP))


@pytest.mark.parametrize("flags", [
    dict(use_int8=True, attn_mode="flash_int8", text_encoder_quant="int8"),
    dict(use_fp8=True, use_int4_modulation=True),
], ids=["int8", "fp8+int4"])
def test_from_pretrained_applies_tiers(monkeypatch, tmp_path, flags):
    """from_pretrained applies the tiers to the block linears (and the LLM)
    and predict runs on the CPU through the plain versions."""
    towers = _tiny_registry(monkeypatch)
    args = InferenceArgs(model="HYVideo-T/2", text_states_dim=64,
                         text_states_dim_2=48, vae_tiling=False, device="cpu",
                         precision="fp32", vae_precision="fp32",
                         text_encoder_precision="fp32",
                         model_base=str(tmp_path), **flags)
    sampler = HunyuanVideoSampler.from_pretrained(
        args=args, allow_random_init=True, **towers)
    dit = sampler.transformer
    kinds = {type(m) for m in dit.double_blocks.modules()}
    if flags.get("use_int8"):
        assert q.Int8Linear in kinds and torch.nn.Linear not in kinds
        assert type(sampler.text_encoder.model.layers[0].mlp.up_proj) \
            is q.Int8Linear
    else:
        assert type(dit.double_blocks[0].img_mod.linear) is q.Int4Linear
        assert type(dit.single_blocks[0].linear1) is q.Fp8Linear
    assert type(dit.final_layer.linear) is torch.nn.Linear
    n0 = (w8a8_linear.LAUNCHES, flash_int8_static.LAUNCHES)
    out = sampler.predict("a dog", 32, 48, 5, seed=1, infer_steps=2,
                          output_dtype="uint8")
    assert out["samples"].shape == (1, 3, 5, 32, 48)
    assert n0 == (w8a8_linear.LAUNCHES, flash_int8_static.LAUNCHES)


def test_from_pretrained_reads_an_fp8_checkpoint(monkeypatch, tmp_path):
    """--use-fp8 with a reference fp8 checkpoint and its `_map.pt` scales
    in the transformers folder: the loader's codes equal quantizing the
    upcast weights, and predict runs."""
    towers = _tiny_registry(monkeypatch)
    cfg = DiTConfig(**DIT)
    src = HYVideoDiT(cfg).eval()
    src.init_weights(torch.Generator().manual_seed(3))
    sd, fp8_map = {}, {}
    for name, t in src.state_dict().items():
        if name.startswith(q.QUANT_BLOCK_KEYS) and t.ndim == 2:
            s = t.abs().amax().clamp_min(1e-6) / 448.0
            sd[name] = (t / s).to(torch.float8_e4m3fn)
            fp8_map[name] = s
        else:
            sd[name] = t.bfloat16()
    folder = tmp_path / "hunyuan-video-t2v-720p" / "transformers"
    folder.mkdir(parents=True)
    ckpt = folder / "pytorch_model_module.pt"
    torch.save({"module": sd}, ckpt)
    torch.save(fp8_map, fp8_map_path(ckpt))
    args = InferenceArgs(model="HYVideo-T/2", text_states_dim=64,
                         text_states_dim_2=48, vae_tiling=False, device="cpu",
                         vae_precision="fp32", text_encoder_precision="fp32",
                         model_base=str(tmp_path), use_fp8=True)
    sampler = HunyuanVideoSampler.from_pretrained(
        args=args, allow_random_init=True, **towers)
    mod = sampler.transformer.double_blocks[0].img_attn_qkv
    assert type(mod) is q.Fp8Linear
    upcast = (sd["double_blocks.0.img_attn_qkv.weight"].float()
              * fp8_map["double_blocks.0.img_attn_qkv.weight"]).bfloat16()
    codes, scale = q.quantize_tensor_fp8(upcast)
    assert torch.equal(mod.weight.view(torch.uint8), codes.view(torch.uint8))
    assert torch.equal(mod.scale, scale)
    out = sampler.predict("a dog", 32, 48, 5, seed=1, infer_steps=1,
                          output_dtype="uint8")
    assert out["samples"].shape == (1, 3, 5, 32, 48)
