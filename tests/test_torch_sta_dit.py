"""The port's MM-DiT and text-to-video pipeline under attn_mode="sta"
against the JAX package on the CPU.

DiT: the tiny config of tests/test_torch_dit.py (hidden 128, 4 heads, 2+2
blocks) with 2x4x4 tiles over a ragged 3x9x10 patch grid, so the 3x3x3
window leaves tiles out; with and without QK-norm (the static direct and
the running permuted STA arms), with 0 and 1 dense anchor blocks. The JAX
side runs dit_forward(attn_mode="sta"), its STA Pallas kernels in interpret
mode; the port runs the wrappers' plain versions. fp32, tolerance 1e-4
relative to the output scale, as tests/test_torch_dit.py.

Pipeline: the 2-step CFG pipeline of tests/test_torch_pipeline.py with an
STA DiT (2x2x2 tiles, a 1x1x1 window, so each tile attends only itself and
the text) from the same injected latents; the float32 video to 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit import dit_forward
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu_torch import inference
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs, parse_args
from hunyuanvideo_efficiency_tpu_torch.inference import (HunyuanVideoSampler,
                                                         get_rotary_pos_embed)
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.models.text import (CLIPTextConfig,
                                                           LlamaConfig)
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import VAEConfig
from hunyuanvideo_efficiency_tpu_torch.ops import sta
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from test_torch_dit import dit_inputs, make_pair
from test_torch_pipeline import CLIP, DIT, LLAMA, VAE, F, H, W, build_pipelines


@pytest.mark.parametrize("dense", [0, 1], ids=["all_sta", "dense_anchor"])
@pytest.mark.parametrize("qk_norm", [True, False],
                         ids=["qk_norm", "no_qk_norm"])
def test_sta_dit_forward_matches_jax(qk_norm, dense):
    params, jcfg, model = make_pair(
        0, attn_mode="sta", qk_norm=qk_norm, sta_tile=(2, 4, 4),
        sta_window=(3, 3, 3), sta_dense_double_blocks=dense,
        sta_dense_single_blocks=dense)
    x, t, txt, mask, txt2 = dit_inputs(1, grid=(3, 18, 20))
    sizes = (3, 9, 10)
    jc, js = jax_rope(jcfg.rope_dim_list, sizes, theta=jcfg.rope_theta)
    tc, ts = get_nd_rotary_pos_embed(model.cfg.rope_dim_list, sizes,
                                     theta=model.cfg.rope_theta, device="cpu")
    ref = np.asarray(dit_forward(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(txt),
        jnp.asarray(mask), jnp.asarray(txt2), jc, js, cfg=jcfg))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(txt),
            torch.from_numpy(mask), torch.from_numpy(txt2), tc, ts)
    with torch.no_grad():
        out = model(*args)
        plain = model(*args, plain=True)
    assert out.shape == ref.shape == x.shape
    scale = np.abs(ref).max()
    assert scale > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * scale,
                               rtol=1e-4)
    # on the CPU the wrappers are the plain version: plain is exact
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_sta_pipeline_matches_jax():
    jpipe, tpipe = build_pipelines(attn_mode="sta", sta_tile=(2, 2, 2),
                                   sta_window=(1, 1, 1))
    latents = np.random.default_rng(5).standard_normal(
        (1, 16, 2, H // 8, W // 8)).astype(np.float32)
    jfreqs = jax_rope(DIT["rope_dim_list"], (2, 2, 3), theta=256.0)
    tcos, tsin, sizes = get_rotary_pos_embed(tpipe.transformer.cfg,
                                             "884-16c-hy", F, H, W,
                                             device="cpu")
    assert sizes == (2, 2, 3)
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
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_sta_flags_reach_the_dit(monkeypatch, tmp_path):
    """--attn-mode sta, --sta-window and --sta-dense-blocks parse, default
    to the card, and from_pretrained builds the DiT with them; predict then
    runs on the CPU with a tiny registry."""
    args = parse_args(["--attn-mode", "sta", "--sta-window", "1", "3", "3",
                       "--sta-dense-blocks", "1"])
    assert (args.attn_mode, args.sta_window, args.sta_dense_blocks,
            args.device) == ("sta", (1, 3, 3), 1, "cuda")
    assert InferenceArgs(attn_mode="sta").device == "cuda"
    monkeypatch.setattr(inference, "load_dit_config",
                        lambda name, **kw: DiTConfig(**DIT, **kw))
    monkeypatch.setattr(inference, "load_vae_config",
                        lambda name: VAEConfig(**VAE))
    args = InferenceArgs(model="HYVideo-T/2", text_states_dim=64,
                         text_states_dim_2=48, vae_tiling=False, device="cpu",
                         precision="fp32", vae_precision="fp32",
                         text_encoder_precision="fp32",
                         model_base=str(tmp_path), attn_mode="sta",
                         sta_window=(1, 3, 3), sta_dense_blocks=1)
    sampler = HunyuanVideoSampler.from_pretrained(
        args=args, allow_random_init=True, llm_config=LlamaConfig(**LLAMA),
        clip_config=CLIPTextConfig(**CLIP))
    cfg = sampler.transformer.cfg
    assert (cfg.attn_mode, cfg.sta_window, cfg.sta_dense_double_blocks,
            cfg.sta_dense_single_blocks) == ("sta", (1, 3, 3), 1, 1)
    counts = sta.sta_direct.LAUNCHES
    out = sampler.predict("a dog", 32, 48, 5, seed=1, infer_steps=1,
                          output_dtype="uint8")
    assert out["samples"].shape == (1, 3, 5, 32, 48)
    assert out["samples"].dtype == torch.uint8
    assert sta.sta_direct.LAUNCHES == counts   # plain version on the CPU
