"""The quantized DiT and Llama of the port against the JAX package on the
CPU: the tiny DiT of tests/test_torch_dit.py under --use-int8 with
attn_mode="flash_int8", under "sta_int8" (2x4x4 tiles on the ragged 3x9x10
grid of tests/test_torch_sta_dit.py), under fp8 + int4 modulation and under
all three tiers; and the tiny Llama under int8.

The JAX weights are quantized by the JAX converters and carried over bit
for bit (utils/weights.py); JAX runs its int8 linears through the XLA body
and its int8 attention through the Pallas kernels in interpret mode, the
port the wrappers' plain versions. fp32 activations. Tolerances, relative
to the output scale: 1e-4 where only fp32 sums differ (fp8 + int4, whose
products run in fp32); 2e-3 under int8 activations, where an fp32 rounding
difference may move one activation to the neighbouring int8 code (one
step, 1/127 of its row's absmax) and the model carries that through its
blocks (2e-4 seen under sta_int8).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit import dit_forward
from hunyuanvideo_efficiency_tpu.models.text import (
    LlamaConfig as JLlamaCfg, init_llama_params, llama_encode)
from hunyuanvideo_efficiency_tpu.models.text.llama import (
    quantize_llama_params_int8)
from hunyuanvideo_efficiency_tpu.ops import quantization as jq
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu_torch.models.text import (LlamaConfig,
                                                           LlamaModel)
from hunyuanvideo_efficiency_tpu_torch.ops import quantization as q
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    dit_state_dict_from_jax, llama_state_dict_from_jax)
from test_torch_dit import dit_inputs, make_pair
from test_torch_pipeline import LLAMA

INT8_TOL = 2e-3


def _close(out, ref, rel):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape and scale > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=rel * scale, rtol=rel)


def _jax_tiers(params, tiers):
    if "fp8" in tiers:
        params = jq.quantize_dit_params_fp8(params)
    if "int8" in tiers:
        params = jq.quantize_dit_params_int8(params)
    if "int4" in tiers:
        params = jq.quantize_dit_params_int4_modulation(params)
    return params


@pytest.mark.parametrize("mode,tiers,grid,rel", [
    ("flash_int8", ("int8",), (3, 2, 3), INT8_TOL),
    ("sta_int8", ("int8",), (3, 9, 10), INT8_TOL),
    ("flash", ("fp8", "int4"), (3, 2, 3), 1e-4),
    ("flash_int8", ("fp8", "int8", "int4"), (3, 2, 3), INT8_TOL),
], ids=["int8-flash_int8", "int8-sta_int8", "fp8+int4", "all-tiers"])
def test_quantized_dit_matches_jax(mode, tiers, grid, rel):
    extra = dict(sta_tile=(2, 4, 4)) if mode.startswith("sta") else {}
    params, jcfg, model = make_pair(0, attn_mode=mode, **extra)
    jp = _jax_tiers(params, tiers)
    q.quantize_dit(model, fp8="fp8" in tiers, int8="int8" in tiers,
                   int4_modulation="int4" in tiers)
    model.load_state_dict(dit_state_dict_from_jax(
        jax.tree.map(np.asarray, jp), model.cfg))
    x, t, txt, mask, txt2 = dit_inputs(1, grid=(grid[0], 2 * grid[1],
                                                2 * grid[2]))
    jc, js = jax_rope(jcfg.rope_dim_list, grid, theta=jcfg.rope_theta)
    tc, ts = get_nd_rotary_pos_embed(model.cfg.rope_dim_list, grid,
                                     theta=model.cfg.rope_theta, device="cpu")
    ref = dit_forward(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(txt),
                      jnp.asarray(mask), jnp.asarray(txt2), jc, js, cfg=jcfg)
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(txt),
            torch.from_numpy(mask), torch.from_numpy(txt2), tc, ts)
    with torch.no_grad():
        out = model(*args)
        plain = model(*args, plain=True)
    _close(out, ref, rel)
    # on the CPU the wrappers are the plain versions: plain=True is exact
    torch.testing.assert_close(plain, out, rtol=0, atol=0)


def test_int8_llama_matches_jax():
    """quantize_llama_params_int8 codes equal the port's quantize_llama_int8
    of the same weights bit for bit, and the int8 towers agree."""
    cfg = LlamaConfig(**LLAMA)
    jl = jax.tree.map(np.asarray, init_llama_params(jax.random.PRNGKey(0),
                                                    JLlamaCfg(**LLAMA)))
    ref_model = LlamaModel(cfg).eval()
    ref_model.load_state_dict(llama_state_dict_from_jax(jl))
    q.quantize_llama_int8(ref_model)
    jq8 = jax.tree.map(np.asarray, quantize_llama_params_int8(jl))
    model = q.quantize_llama_int8(LlamaModel(cfg).eval())
    model.load_state_dict(llama_state_dict_from_jax(jq8))
    for (k, a), (_, b) in zip(ref_model.state_dict().items(),
                              model.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert type(model.layers[0].self_attn.q_proj) is q.Int8Linear
    assert model.layers[0].self_attn.q_proj.bias is None
    rng = np.random.default_rng(0)
    ids = rng.integers(2, LLAMA["vocab_size"] - 1, (2, 12)).astype(np.int32)
    mask = np.ones((2, 12), np.int32)
    mask[1, 7:] = 0
    ref = llama_encode(jax.tree.map(jnp.asarray, jq8), jnp.asarray(ids),
                       jnp.asarray(mask), JLlamaCfg(**LLAMA),
                       hidden_state_skip_layer=1, dtype=jnp.float32)
    out = model.encode(torch.from_numpy(ids).long(), torch.from_numpy(mask),
                       1)
    _close(out, ref, INT8_TOL)
