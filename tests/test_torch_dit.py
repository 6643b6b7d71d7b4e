"""The port's MM-DiT against the JAX dit_forward on the CPU.

Tiny config (hidden 128, 4 heads of 32, 2 double + 2 single blocks, RoPE
(8, 12, 12)); the JAX params come from init_dit_params with the zero-init
adaLN and final layers randomized (else every block is the identity), and
reach the port through utils/weights.py. The JAX side runs
attn_mode="flash", i.e. its Pallas flash kernels in interpret mode; the
port runs the flash wrappers' plain versions. fp32; tolerance 1e-4
relative to the output scale (fp32 sums in other orders through 4 blocks).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit import dit_forward, init_dit_params
from hunyuanvideo_efficiency_tpu.models.dit_config import DiTConfig as JCfg
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu_torch.models.dit import (HYVideoDiT,
                                                          patchify_raw,
                                                          unpatchify)
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    dit_state_dict_from_jax)

TINY = dict(hidden_size=128, heads_num=4, mm_double_blocks_depth=2,
            mm_single_blocks_depth=2, rope_dim_list=(8, 12, 12),
            text_states_dim=64, text_states_dim_2=32)


def randomize(tree, rng, keys=("img_mod", "txt_mod", "modulation",
                               "adaLN_modulation", "final_layer")):
    """Give the zero-initialized adaLN and final layers random values."""
    def walk(node, hot):
        if isinstance(node, dict):
            return {k: walk(v, hot or k in keys) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, hot) for v in node]
        a = np.asarray(node, np.float32)
        return (rng.standard_normal(a.shape).astype(np.float32) * 0.05
                if hot else a)
    return walk(tree, False)


def make_pair(seed=0, **overrides):
    """(JAX params, JAX cfg, port model) with identical weights."""
    jcfg = JCfg(**{"attn_mode": "flash", **TINY, **overrides})
    params = randomize(init_dit_params(jax.random.PRNGKey(seed), jcfg),
                       np.random.default_rng(seed))
    cfg = DiTConfig(**TINY, **overrides)
    model = HYVideoDiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax(params, cfg))
    return jax.tree.map(jnp.asarray, params), jcfg, model.eval()


def dit_inputs(seed, b=2, grid=(3, 4, 6), l_txt=8, cfg=TINY):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 16, *grid)).astype(np.float32)
    t = np.array([900.0, 250.0][:b], np.float32)
    txt = rng.standard_normal((b, l_txt, cfg["text_states_dim"])
                              ).astype(np.float32)
    mask = np.ones((b, l_txt), np.int32)
    mask[-1, 5:] = 0
    txt2 = rng.standard_normal((b, cfg["text_states_dim_2"])
                               ).astype(np.float32)
    return x, t, txt, mask, txt2


@pytest.mark.parametrize("overrides", [
    dict(guidance_embed=True),
    dict(qk_norm=False),                 # no analytic bound: "auto" dispatch
])
def test_dit_forward_matches_jax(overrides):
    params, jcfg, model = make_pair(0, **overrides)
    x, t, txt, mask, txt2 = dit_inputs(1)
    sizes = (3, 2, 3)
    jc, js = jax_rope(jcfg.rope_dim_list, sizes, theta=jcfg.rope_theta)
    tc, ts = get_nd_rotary_pos_embed(model.cfg.rope_dim_list, sizes,
                                     theta=model.cfg.rope_theta, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    g = np.full((2,), 6000.0, np.float32) if jcfg.guidance_embed else None
    ref = dit_forward(params, jnp.asarray(x), jnp.asarray(t),
                      jnp.asarray(txt), jnp.asarray(mask), jnp.asarray(txt2),
                      jc, js, None if g is None else jnp.asarray(g), cfg=jcfg)
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(txt), torch.from_numpy(mask),
                    torch.from_numpy(txt2), tc, ts,
                    None if g is None else torch.from_numpy(g))
    ref = np.asarray(ref)
    assert out.shape == ref.shape == x.shape
    scale = np.abs(ref).max()
    assert scale > 1e-2  # not the identity-map degenerate case
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * scale,
                               rtol=1e-4)


def test_patchify_roundtrip():
    x = torch.randn(2, 16, 3, 4, 6)
    tok = patchify_raw(x, (1, 2, 2))
    assert tok.shape == (2, 18, 64)
    # both order a token's features (C, pt, ph, pw)
    torch.testing.assert_close(unpatchify(tok, 3, 2, 3, 16, (1, 2, 2)), x)


def test_random_init_is_identity_then_not():
    """init_weights zero-inits the adaLN/final layers like the JAX init:
    the untouched model outputs exactly zero."""
    cfg = DiTConfig(**TINY)
    model = HYVideoDiT(cfg).eval()
    model.init_weights(torch.Generator().manual_seed(0))
    x, t, txt, mask, txt2 = dit_inputs(2)
    tc, ts = get_nd_rotary_pos_embed(cfg.rope_dim_list, (3, 2, 3),
                                     device="cpu")
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(txt), torch.from_numpy(mask),
                    torch.from_numpy(txt2), tc, ts)
    assert torch.count_nonzero(out) == 0
    assert dataclasses.asdict(cfg)["attn_mode"] == "auto"
