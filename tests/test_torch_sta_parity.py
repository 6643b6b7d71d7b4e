"""The port's sliding-tile attention (ops/sta.py) against the JAX package's
on the CPU: the tile plans, the token layouts, `sta_joint_attention` in
every arm and its int8 arms, and the text merge.

The JAX side runs `sta_joint_attention` as tests/test_sta.py does: its
Pallas kernels in interpret mode, the text queries through its chunked
attention. The port runs the kernel wrappers' plain versions. Inputs are
numpy draws from a seed, fp32; tolerance atol 2e-5 times the output scale,
rtol 1e-5 (fp32 sums in other orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.ops import sta as jsta
from hunyuanvideo_efficiency_tpu_torch.ops import sta
from sta_cases import (
    ARMS, GEOMETRIES, INT8_ARMS, NEG_INF, _close, _inputs, _jax, _torch)


@pytest.mark.parametrize("txt_pad", [0, 32, 40])
@pytest.mark.parametrize("geom", GEOMETRIES + [((17, 34, 60), (4, 8, 8),
                                                (3, 3, 3))])
def test_tile_plan_matches_jax(geom, txt_pad):
    got = sta.tile_plan(*geom, txt_pad)
    want = jsta.tile_plan(*geom, txt_pad)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


@pytest.mark.parametrize("geom", GEOMETRIES[:2])
def test_token_layouts_match_jax(geom):
    grid, tile, window = geom
    (q, _, _), _, _, _ = _inputs(grid, seed=1)
    plan = sta.tile_plan(grid, tile, window, 0)
    got = sta._permute_tokens(torch.from_numpy(q), grid, tile, plan)
    want = np.asarray(jsta._permute_tokens(jnp.asarray(q), grid, tile,
                                           jsta.tile_plan(grid, tile,
                                                          window, 0)))
    b, s_pad, h, d = got.shape
    np.testing.assert_array_equal(got.reshape(b, s_pad, h * d).numpy(),
                                  want)
    pad5 = sta._pad_tokens_5d(torch.from_numpy(q), grid, plan["padded_grid"])
    np.testing.assert_array_equal(pad5.numpy(), np.asarray(
        jsta._pad_tokens_5d(jnp.asarray(q), grid, plan["padded_grid"])))
    back = sta._unpermute_tokens(got.reshape(b, s_pad, h * d), grid, plan)
    np.testing.assert_array_equal(back.numpy(), q.reshape(b, -1, h * d))
    np.testing.assert_array_equal(
        sta.sta_reference_mask(grid, tile, window, q.shape[1]),
        jsta.sta_reference_mask(grid, tile, window, q.shape[1]))


@pytest.mark.parametrize("key_bias", [False, True],
                         ids=["no_key_bias", "key_bias"])
@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["ragged", "even", "window133"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_sta_joint_attention_matches_jax(arm, geom, key_bias):
    grid, tile, window = geom
    img, txt, tb, ikb = _inputs(grid, seed=2, key_bias=key_bias)
    kw = dict(grid=grid, tile=tile, window=window, **ARMS[arm])
    want = jsta.sta_joint_attention(*_jax(*img, *txt, tb), **kw,
                                    img_key_bias=_jax(ikb)[0])
    got = sta.sta_joint_attention(*_torch(*img, *txt, tb), **kw,
                                  img_key_bias=_torch(ikb)[0])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("key_bias", [False, True],
                         ids=["no_key_bias", "key_bias"])
@pytest.mark.parametrize("score_bound", [None, 2.0], ids=["cs", "bound"])
@pytest.mark.parametrize("arm", list(INT8_ARMS))
def test_sta_int8_matches_jax(arm, score_bound, key_bias):
    """Both quant arms on the ragged grid against JAX's
    sta_joint_attention(qk_int8=True), with the Cauchy-Schwarz bound or a
    given one (inflated inside); the int8 codes agree exactly, so the fp32
    tolerance of the bf16 arms holds."""
    grid, tile, window = GEOMETRIES[0]
    img, txt, tb, ikb = _inputs(grid, seed=7, key_bias=key_bias)
    kw = dict(grid=grid, tile=tile, window=window, **INT8_ARMS[arm])
    want = jsta.sta_joint_attention(
        *_jax(*img, *txt, tb), **kw, img_key_bias=_jax(ikb)[0],
        score_bound=None if score_bound is None else jnp.float32(score_bound))
    got = sta.sta_joint_attention(
        *_torch(*img, *txt, tb), **kw, img_key_bias=_torch(ikb)[0],
        score_bound=None if score_bound is None else torch.tensor(
            score_bound))
    for g, w in zip(got, want):
        _close(g, w)


def test_txt_merge_attention_matches_jax():
    """Text queries over padded image keys (any token order, padding
    masked by img_bias) merged with the text keys, as the JAX function."""
    rng = np.random.default_rng(4)
    b, s_pad, lt, h, d = 2, 96, 24, 2, 32
    kp, vp = (rng.standard_normal((b, s_pad, h * d)).astype(np.float32) * 0.5
              for _ in range(2))
    tq, tk, tv = (rng.standard_normal((b, lt, h, d)).astype(np.float32) * 0.5
                  for _ in range(3))
    img_bias = np.where(rng.random((b, s_pad)) > 0.25, 0.0,
                        NEG_INF).astype(np.float32)
    tb = np.where(rng.random((b, lt)) > 0.3, 0.0, NEG_INF).astype(
        np.float32)[:, None, None, :]
    c = np.full((b, h), 4.0, np.float32)
    want = jsta.txt_merge_attention(*_jax(tq, kp, vp, img_bias, tk, tv, tb,
                                          c), d ** -0.5)
    got = sta.txt_merge_attention(*_torch(tq, kp, vp, img_bias, tk, tv, tb,
                                          c), d ** -0.5)
    _close(got, want)
