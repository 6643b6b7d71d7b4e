"""The port's Llama and CLIP towers and TextEncoder against the JAX package
on the CPU, at 2 layers. Both run in this one process: HashTokenizer ids
come from the per-process salted `hash`. fp32; tolerance 1e-4 relative to
the output scale.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.text import (
    CLIPTextConfig as JClipCfg, LlamaConfig as JLlamaCfg,
    TextEncoder as JTextEncoder, clip_encode, init_clip_params,
    init_llama_params, llama_encode)
from hunyuanvideo_efficiency_tpu_torch.models.text import (
    CLIPTextConfig, CLIPTextModel, LlamaConfig, LlamaModel, TextEncoder)
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    clip_state_dict_from_jax, llama_state_dict_from_jax)

LLAMA = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2)
CLIP = dict(vocab_size=96, hidden_size=48, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, eos_token_id=95)
TPL = {"template": "instr {} end", "crop_start": 2}


def _close(out, ref, rel=1e-4):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=rel * np.abs(ref).max(), rtol=rel)


@pytest.fixture(scope="module")
def towers():
    jl = jax.tree.map(np.asarray, init_llama_params(jax.random.PRNGKey(0),
                                                    JLlamaCfg(**LLAMA)))
    jc = jax.tree.map(np.asarray, init_clip_params(jax.random.PRNGKey(1),
                                                   JClipCfg(**CLIP)))
    llama = LlamaModel(LlamaConfig(**LLAMA)).eval()
    llama.load_state_dict(llama_state_dict_from_jax(jl))
    clip = CLIPTextModel(CLIPTextConfig(**CLIP)).eval()
    clip.load_state_dict(clip_state_dict_from_jax(jc))
    return jl, jc, llama, clip


def _ids(vocab, b=2, l=12):
    rng = np.random.default_rng(0)
    ids = rng.integers(2, vocab - 1, (b, l)).astype(np.int32)
    mask = np.ones((b, l), np.int32)
    mask[1, 7:] = 0
    return ids, mask


@pytest.mark.parametrize("skip,final_norm", [(1, False), (0, False),
                                             (1, True)])
def test_llama_matches_jax(towers, skip, final_norm):
    jl, _, llama, _ = towers
    ids, mask = _ids(LLAMA["vocab_size"])
    ref = llama_encode(jax.tree.map(jnp.asarray, jl), jnp.asarray(ids),
                       jnp.asarray(mask), JLlamaCfg(**LLAMA),
                       hidden_state_skip_layer=skip,
                       apply_final_norm=final_norm, dtype=jnp.float32)
    out = llama.encode(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       skip, final_norm)
    _close(out, ref)


def test_clip_matches_jax(towers):
    _, jc, _, clip = towers
    ids, mask = _ids(CLIP["vocab_size"])
    ids[:, 9] = CLIP["eos_token_id"]
    hidden, pooled = clip_encode(jax.tree.map(jnp.asarray, jc),
                                 jnp.asarray(ids), jnp.asarray(mask),
                                 JClipCfg(**CLIP), dtype=jnp.float32)
    th, tp = clip.encode(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    _close(th, hidden)
    _close(tp, pooled)


def test_text_encoder_prompts_match_jax(towers):
    """Templates, HashTokenizer, crop_start and the pooled CLIP output, from
    prompt strings."""
    jl, jc, llama, clip = towers
    prompts = ["a cat on a red sofa", "two dogs"]
    jllm = JTextEncoder("llm", 16, params=jax.tree.map(jnp.asarray, jl),
                        model_config=JLlamaCfg(**LLAMA), prompt_template=TPL,
                        prompt_template_video=TPL, hidden_state_skip_layer=1,
                        dtype=jnp.float32)
    tllm = TextEncoder("llm", 16, llama, prompt_template=TPL,
                       prompt_template_video=TPL, hidden_state_skip_layer=1)
    ref, ref_mask = jllm.encode_prompt(prompts, data_type="video",
                                       num_videos=2)
    out, out_mask = tllm.encode_prompt(prompts, data_type="video",
                                       num_videos=2)
    assert out.shape == (4, 14, LLAMA["hidden_size"])
    _close(out, ref)
    np.testing.assert_array_equal(out_mask.numpy(), np.asarray(ref_mask))

    jclip = JTextEncoder("clipL", 20, params=jax.tree.map(jnp.asarray, jc),
                         model_config=JClipCfg(**CLIP), dtype=jnp.float32)
    tclip = TextEncoder("clipL", 20, clip)
    ref2, none2 = jclip.encode_prompt(prompts)
    out2, tnone2 = tclip.encode_prompt(prompts)
    assert none2 is None and tnone2 is None
    _close(out2, ref2)
