"""The port's sliding-tile attention (ops/sta.py) against the JAX package's
on the CPU.

The JAX side runs `sta_joint_attention` as tests/test_sta.py does: its
Pallas kernels in interpret mode, the text queries through its chunked
attention. The port runs the kernel wrappers' plain versions. Inputs are
numpy draws from a seed, fp32; tolerance atol 2e-5 times the output scale,
rtol 1e-5 (fp32 sums in other orders).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuanvideo_efficiency_tpu.ops import sta as jsta
from hunyuanvideo_efficiency_tpu_torch.ops import sta
from hunyuanvideo_efficiency_tpu_torch.ops.attention import (attention,
                                                             joint_attention)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    int8_bound_inflation)

NEG_INF = -1e30
GEOMETRIES = [
    # grid, tile, window
    ((3, 9, 10), (2, 4, 4), (3, 3, 3)),   # ragged grid
    ((4, 8, 8), (2, 4, 4), (3, 3, 3)),
    ((4, 8, 8), (2, 4, 4), (1, 3, 3)),    # anisotropic window
]
ARMS = {
    "static_direct": dict(bound_mode="static"),
    "static_permuted_fused": dict(bound_mode="static", direct=False),
    "static_permuted_unfused": dict(bound_mode="static", fused=False),
    "running": dict(bound_mode="auto"),
}
# the quant arms (sta_int8): int8 Q.K^T with tile scales; the direct arm's
# text keys stay in the input type, the permuted arms quantize them
INT8_ARMS = {
    "int8_direct": dict(bound_mode="static", qk_int8=True),
    "int8_permuted_fused": dict(bound_mode="static", qk_int8=True,
                                direct=False),
    "int8_permuted_unfused": dict(bound_mode="static", qk_int8=True,
                                  fused=False),
}


def _inputs(grid, seed=0, b=2, h=2, d=32, lt=24, key_bias=False):
    """img q/k/v, txt q/k/v (numpy, 0.5 * N(0, 1)), a text padding bias
    [B, 1, 1, Lt] and optionally an image key bias [B, S_img]."""
    rng = np.random.default_rng(seed)
    s = grid[0] * grid[1] * grid[2]
    img = [rng.standard_normal((b, s, h, d)).astype(np.float32) * 0.5
           for _ in range(3)]
    txt = [rng.standard_normal((b, lt, h, d)).astype(np.float32) * 0.5
           for _ in range(3)]
    mask = rng.random((b, lt)) > 0.3
    mask[:, 0] = True
    tb = np.where(mask, 0.0, NEG_INF).astype(np.float32)[:, None, None, :]
    ikb = None
    if key_bias:
        ikb = np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
        ikb = (ikb + rng.standard_normal((b, s)) * 0.3).astype(np.float32)
    return img, txt, tb, ikb


def _torch(*xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _jax(*xs):
    return [None if x is None else jnp.asarray(x) for x in xs]


def _close(out, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert out.shape == ref.shape and scale > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5 * scale,
                               rtol=1e-5)


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


def test_wrappers_on_cpu_are_the_plain_version():
    """On CPU tensors every wrapper returns its plain version's result and
    counts no launch; the permuted layout leaves padding rows zero."""
    grid, tile, window = GEOMETRIES[0]
    img, txt, tb, _ = _inputs(grid, seed=3)
    iq, ik, iv, _, tk, tv, tbt = _torch(*img, *txt, tb)
    c = torch.full((2, 2), 3.0)
    scale = 32 ** -0.5
    counts = (sta.sta_direct.LAUNCHES, sta.sta_permuted_static.LAUNCHES,
              sta.sta_permuted_running.LAUNCHES)
    ref = sta.sta_attention_plain(iq, ik, iv, tk, tv, tbt, grid, tile,
                                  window, scale, c)
    torch.testing.assert_close(
        sta.sta_direct(iq, ik, iv, tk, tv, tbt, c, grid, tile, window,
                       scale), ref, rtol=0, atol=0)
    plan, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tbt, grid, tile, window)
    out_p = sta.sta_permuted_static(qp, kcat, vcat, kb, c, grid, tile,
                                    window, scale)
    torch.testing.assert_close(sta._unpermute_tokens(out_p, grid, plan),
                               ref, rtol=0, atol=0)
    valid = sta._valid_tokens(grid, plan["padded_grid"]).reshape(-1)
    assert not out_p[:, ~torch.from_numpy(valid[plan["perm"]])].any()
    running = sta._unpermute_tokens(sta.sta_permuted_running(
        qp, kcat, vcat, kb, grid, tile, window, scale), grid, plan)
    torch.testing.assert_close(
        running, sta.sta_attention_plain(iq, ik, iv, tk, tv, tbt, grid,
                                         tile, window, scale),
        rtol=0, atol=0)
    torch.testing.assert_close(
        sta.sta_direct_int8(iq, ik, iv, tk, tv, tbt, c, grid, tile, window,
                            scale),
        sta.sta_attention_plain(iq, ik, iv, tk, tv, tbt, grid, tile, window,
                                scale, c, qk_int8=True), rtol=0, atol=0)
    torch.testing.assert_close(
        sta.sta_permuted_static_int8(qp, kcat, vcat, kb, c, grid, tile,
                                     window, scale),
        sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window, scale,
                               c, qk_int8=True), rtol=0, atol=0)
    assert counts == (sta.sta_direct.LAUNCHES,
                      sta.sta_permuted_static.LAUNCHES,
                      sta.sta_permuted_running.LAUNCHES)
    assert sta.sta_direct_int8.LAUNCHES == 0
    assert sta.sta_permuted_static_int8.LAUNCHES == 0


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


def test_sta_pair_count_matches_dense_mask():
    grid, tile, window = GEOMETRIES[0]
    s = grid[0] * grid[1] * grid[2]
    mask = sta.sta_reference_mask(grid, tile, window, s)
    assert sta.sta_pair_count(grid, tile, window, 7) == mask.sum() + 7 * s


@pytest.mark.parametrize("kw,exc,match", [
    (dict(qk_int8=True, bound_mode="auto"), ValueError, "int8"),
    (dict(lane_rotate="grouped", bound_mode="static"), NotImplementedError,
     "lane rotation"),
], ids=["kw0-int8", "kw2-lane rotation"])
def test_unported_options_raise(kw, exc, match):
    """Options not ported raise; qk_int8 without the static bound raises
    as in JAX."""
    grid, tile, window = GEOMETRIES[0]
    img, txt, tb, _ = _inputs(grid, seed=5)
    with pytest.raises(exc, match=match):
        sta.sta_joint_attention(*_torch(*img, *txt, tb), grid=grid,
                                tile=tile, window=window, **kw)


def test_sta_modes_dispatch_and_reject():
    grid, tile, window = GEOMETRIES[0]
    img, txt, tb, _ = _inputs(grid, seed=6)
    args = _torch(*img, *txt, tb)
    with pytest.raises(ValueError, match="static"):
        joint_attention(*args, mode="sta_int8", token_grid=grid,
                        sta_tile=tile, sta_window=window)
    with pytest.raises(ValueError, match="token_grid"):
        joint_attention(*args, mode="sta")
    with pytest.raises(ValueError, match="joint_attention"):
        attention(args[0], args[1], args[2], mode="sta")
    for mode, qk_int8 in (("sta", False), ("sta_int8", True)):
        got = joint_attention(*args, mode=mode, token_grid=grid,
                              sta_tile=tile, sta_window=window,
                              bound_mode="static")
        want = sta.sta_joint_attention(*args, grid=grid, tile=tile,
                                       window=window, bound_mode="static",
                                       qk_int8=qk_int8)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


# B4's host plan (csrc/sta_direct.cu): the 540p main path, the 720p
# headline, the CUDA tests' 64-token tiles and a tile whose 128-token boxes
# are half an (h, w) plane
@pytest.mark.parametrize("grid,tile,quant,want", [
    ((17, 34, 60), (4, 8, 8), False,
     dict(rows=128, box=(2, 8, 8), subs=2, boxes=1,
          blocks=(400, 24, 2), txt_keys=128, txt_chunks=2,
          stages=3, smem=232208)),
    ((17, 34, 60), (4, 8, 8), True,
     dict(rows=128, box=(2, 8, 8), subs=2, boxes=1,
          blocks=(400, 24, 2), txt_keys=64, txt_chunks=4,
          stages=3, smem=200976)),
    ((33, 45, 80), (4, 8, 8), False,
     dict(rows=128, box=(2, 8, 8), subs=2, boxes=1,
          blocks=(1080, 24, 2), txt_keys=128, txt_chunks=2,
          stages=3, smem=232208)),
    ((5, 9, 13), (2, 4, 8), False,
     dict(rows=64, box=(2, 4, 8), subs=1, boxes=2,
          blocks=(18, 24, 2), txt_keys=128, txt_chunks=2,
          stages=3, smem=232208)),
    ((4, 40, 40), (1, 16, 16), False,
     dict(rows=128, box=(1, 8, 16), subs=2, boxes=1,
          blocks=(72, 24, 2), txt_keys=128, txt_chunks=2,
          stages=3, smem=232208)),
], ids=["540p", "540p_int8", "720p", "tile64", "half_plane"])
def test_plan_sta_direct_pins(grid, tile, quant, want):
    plan = sta.plan_sta_direct(2, 24, 128, grid, tile, (3, 3, 3), 256,
                               quant)
    assert dataclasses.asdict(plan) == want
    assert plan.smem <= 232448      # the H100's shared memory a block
    # 5-D maps over q (contiguous) and v (a column view of fused qkv)
    s = grid[0] * grid[1] * grid[2]
    for rs in (24 * 128, 3 * 24 * 128):
        dims, strides, box = sta.sta_grid_map(grid, plan, 2, 24 * 128, rs,
                                              s * rs, 2)
        assert dims == (24 * 128, grid[2], grid[1], grid[0], 2)
        assert strides == (2 * rs, 2 * rs * grid[2],
                           2 * rs * grid[2] * grid[1], 2 * s * rs)
        assert all(x % 16 == 0 and x < 2 ** 40 for x in strides)
        assert box[0] * 2 == 128 and box[1] * box[2] * box[3] == plan.rows
        assert max(box) <= 256


# B6q's plan: the same launch with int8 codes of Q and K (half their bytes)
# and (factor, bias) pairs a key
@pytest.mark.parametrize("grid,tile,d,want", [
    ((17, 34, 60), (4, 8, 8), 128,
     dict(rows=128, subs=2, boxes=1, n_boxes=56, blocks=(400, 24, 2),
          stages=3, smem=168168)),
    ((5, 9, 13), (2, 4, 8), 128,
     dict(rows=64, subs=1, boxes=2, n_boxes=31, blocks=(18, 24, 2),
          stages=3, smem=168168)),
    ((7, 16, 16), (3, 8, 8), 64,
     dict(rows=64, subs=3, boxes=2, n_boxes=87, blocks=(36, 24, 2),
          stages=3, smem=86248)),
], ids=["540p", "tile64", "tile192_d64"])
def test_plan_sta_permuted_int8_pins(grid, tile, d, want):
    block = tile[0] * tile[1] * tile[2]
    plan = sta.plan_sta_permuted(2, 24, d, grid, tile, (3, 3, 3),
                                 sta._ceil(256, block) * block, quant=True)
    assert dataclasses.asdict(plan) == want
    assert plan.smem <= 232448      # the H100's shared memory a block


def test_plan_sta_permuted_names_its_caller():
    """Outside the gate the plan raises with the caller's name."""
    for name in ("sta_permuted_static", "sta_permuted_static_int8"):
        with pytest.raises(ValueError, match=f"^{name}: head_dim"):
            sta.plan_sta_permuted(1, 2, 32, (4, 8, 16), (2, 4, 8), (3, 3, 3),
                                  64, quant=name.endswith("int8"), name=name)


@pytest.mark.parametrize("tile,window,d,match", [
    ((2, 4, 4), (3, 3, 3), 128, "32 tokens"),
    ((3, 8, 8), (3, 3, 3), 128, "192 tokens"),
    ((1, 16, 24), (3, 3, 3), 128, "planes"),
    ((4, 8, 8), (2, 3, 3), 128, "odd"),
    ((4, 8, 8), (3, 3, 3), 32, "head_dim"),
])
def test_sta_direct_gate_rejects(tile, window, d, match):
    """Outside its gate B4 raises (on the card; the CPU runs the plain
    version whatever the tile)."""
    assert match in sta.sta_direct_gate(tile, window, d)
    with pytest.raises(ValueError, match=match):
        sta.plan_sta_direct(1, 2, d, (8, 16, 16), tile, window, 8)


@pytest.mark.parametrize("grid,tile,window", [
    ((5, 9, 13), (2, 4, 8), (3, 3, 3)),
    ((4, 8, 16), (2, 4, 8), (1, 3, 3)),
    ((5, 17, 30), (4, 8, 8), (3, 3, 3)),
    ((17, 34, 60), (4, 8, 8), (3, 3, 3)),
])
def test_sta_walk_covers_the_valid_pairs(grid, tile, window):
    """The kernel's walk: every block's valid query rows times the valid
    keys of its chunks, plus the text, is the exact pair count of the STA
    function; no key is visited twice; an interior 540p tile takes 27 tiles
    x 2 boxes."""
    plan = sta.plan_sta_direct(1, 1, 128, grid, tile, window, 7)
    pairs, n_tiles = 0, plan.blocks[0] // plan.subs
    for qt in range(n_tiles):
        keys = [sta.sta_box_tokens(grid, tile, plan, kt, sub)
                for chunk in sta.sta_walk(grid, tile, window, plan, qt)
                for kt, sub in chunk]
        keys = np.concatenate(keys)
        keys = keys[keys >= 0]
        assert np.unique(keys).size == keys.size
        rows = sum(int((sta.sta_box_tokens(grid, tile, plan, qt, sub)
                        >= 0).sum()) for sub in range(plan.subs))
        pairs += rows * (keys.size + 7)
    assert pairs == sta.sta_pair_count(grid, tile, window, 7)
    if grid == (17, 34, 60):
        chunks = sta.sta_walk(grid, tile, window, plan, (1 * 5 + 2) * 8 + 3)
        assert len(chunks) == 54 and all(len(c) == 1 for c in chunks)


# the CUDA tests' STA_CASES (grid, tile, window, text keys, valid text keys
# of batch 1) at small widths
EMULATED = [((5, 9, 13), (2, 4, 8), (3, 3, 3), 37, 20),
            ((4, 8, 16), (2, 4, 8), (1, 3, 3), 160, 5),
            ((5, 17, 30), (4, 8, 8), (3, 3, 3), 256, 40)]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("case", EMULATED, ids=["ragged", "masked_txt",
                                                "main_tile"])
def test_sta_direct_emulation_matches_plain(case, quant):
    """B4's walk with zero-filled boxes and the geometry bias
    (sta_direct_emulate) is the function of sta_attention_plain, with and
    without an image key bias; fp32, sums in another order."""
    grid, tile, window, lt, txt_valid = case
    rng = np.random.default_rng(11)
    b, h, d = 2, 2, 64
    s = grid[0] * grid[1] * grid[2]
    img = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32) * 0.5) for _ in range(3)]
    tk, tv = (torch.from_numpy(rng.standard_normal((b, lt, h, d)).astype(
        np.float32) * 0.5) for _ in range(2))
    tb = torch.zeros(b, 1, 1, lt)
    tb[1, ..., txt_valid:] = NEG_INF
    ikb = torch.from_numpy(np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
                           .astype(np.float32))
    c = torch.full((b, h), 3.0)
    for kb in (None, ikb):
        got = sta.sta_direct_emulate(*img, tk, tv, tb, c, grid, tile, window,
                                     d ** -0.5, kb, quant)
        want = sta.sta_attention_plain(*img, tk, tv, tb, grid, tile, window,
                                       d ** -0.5, c, kb, qk_int8=quant)
        _close(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_sta_direct_emulation_matches_jax_kernel(quant):
    """The walk against JAX's _sta_nomax_direct_kernel in interpret mode
    (sta_joint_attention's static direct arm) on a ragged grid of 64-token
    tiles, whose key chunks pair two tiles."""
    grid, tile, window, lt, _ = EMULATED[0]
    img, txt, tb, ikb = _inputs(grid, seed=12, d=64, lt=lt, key_bias=True)
    bound = 2.0
    kw = dict(grid=grid, tile=tile, window=window, bound_mode="static",
              qk_int8=quant)
    want, _ = jsta.sta_joint_attention(*_jax(*img, *txt, tb), **kw,
                                       img_key_bias=_jax(ikb)[0],
                                       score_bound=jnp.float32(bound))
    d = img[0].shape[-1]
    c = torch.full((2, 2), bound * (int8_bound_inflation(d) if quant
                                    else 1.0))
    iq, ik, iv, _, tk, tv, tbt, kb = _torch(*img, *txt, tb, ikb)
    got = sta.sta_direct_emulate(iq, ik, iv, tk, tv, tbt, c, grid, tile,
                                 window, d ** -0.5, kb, quant)
    _close(got, want)


def test_sta_tile_codes_plain_is_tile_codes():
    """B4q's pre-pass layout: the row-major codes, moved back to tile-major
    order with the rows past the grid zero, are tile_codes' bit for bit,
    and the scales are its scales; on CPU tensors the wrapper is the plain
    version."""
    grid, tile, window = (5, 9, 13), (2, 4, 8), (3, 3, 3)
    rng = np.random.default_rng(13)
    q, k = (torch.from_numpy(rng.standard_normal((2, 585, 3, 64)).astype(
        np.float32)).bfloat16() for _ in range(2))
    q8, k8, sq, sk = sta.sta_tile_codes(q, k, grid, tile)
    plan = sta.tile_plan(grid, tile, window, 0)
    for x, codes, scales in ((q, q8, sq), (k, k8, sk)):
        want, want_sc = sta.tile_codes(
            sta._permute_tokens(x, grid, tile, plan), 64)
        got = sta._permute_tokens(codes.reshape(2, 585, 3, 64), grid, tile,
                                  plan)
        assert codes.dtype == torch.int8 and codes.shape == (2, 585, 192)
        assert torch.equal(got.float(), want.reshape(got.shape))
        assert torch.equal(scales, want_sc.permute(0, 2, 1))


# B7's host plan (csrc/sta_permuted.cu): the 540p main path, a 64-token
# tile (two boxes a key chunk) and a 192-token tile (64-row boxes, three a
# tile)
@pytest.mark.parametrize("grid,tile,want", [
    ((17, 34, 60), (4, 8, 8),
     dict(rows=128, subs=2, boxes=1, n_boxes=56, blocks=(400, 24, 2),
          stages=3, smem=232168)),
    ((5, 9, 13), (2, 4, 8),
     dict(rows=64, subs=1, boxes=2, n_boxes=31, blocks=(18, 24, 2),
          stages=3, smem=232168)),
    ((7, 16, 16), (3, 8, 8),
     dict(rows=64, subs=3, boxes=2, n_boxes=87, blocks=(36, 24, 2),
          stages=3, smem=232168)),
], ids=["540p", "tile64", "tile192"])
def test_plan_sta_permuted_pins(grid, tile, want):
    block = tile[0] * tile[1] * tile[2]
    plan = sta.plan_sta_permuted(2, 24, 128, grid, tile, (3, 3, 3),
                                 sta._ceil(256, block) * block)
    assert dataclasses.asdict(plan) == want
    assert plan.smem <= 232448      # the H100's shared memory a block


# B6q's plan: the same launch with int8 codes of Q and K (half their bytes)
# and (factor, bias) pairs a key
@pytest.mark.parametrize("grid,tile,d,want", [
    ((17, 34, 60), (4, 8, 8), 128,
     dict(rows=128, subs=2, boxes=1, n_boxes=56, blocks=(400, 24, 2),
          stages=3, smem=168168)),
    ((5, 9, 13), (2, 4, 8), 128,
     dict(rows=64, subs=1, boxes=2, n_boxes=31, blocks=(18, 24, 2),
          stages=3, smem=168168)),
    ((7, 16, 16), (3, 8, 8), 64,
     dict(rows=64, subs=3, boxes=2, n_boxes=87, blocks=(36, 24, 2),
          stages=3, smem=86248)),
], ids=["540p", "tile64", "tile192_d64"])
def test_plan_sta_permuted_int8_pins(grid, tile, d, want):
    block = tile[0] * tile[1] * tile[2]
    plan = sta.plan_sta_permuted(2, 24, d, grid, tile, (3, 3, 3),
                                 sta._ceil(256, block) * block, quant=True)
    assert dataclasses.asdict(plan) == want
    assert plan.smem <= 232448      # the H100's shared memory a block


def test_plan_sta_permuted_names_its_caller():
    """Outside the gate the plan raises with the caller's name."""
    for name in ("sta_permuted_static", "sta_permuted_static_int8"):
        with pytest.raises(ValueError, match=f"^{name}: head_dim"):
            sta.plan_sta_permuted(1, 2, 32, (4, 8, 16), (2, 4, 8), (3, 3, 3),
                                  64, quant=name.endswith("int8"), name=name)


@pytest.mark.parametrize("tile,window,d,match", [
    ((2, 4, 4), (3, 3, 3), 128, "32 tokens"),
    ((4, 8, 8), (3, 3, 3), 32, "head_dim"),
    ((2, 4, 8), (11, 11, 11), 128, "key boxes"),
])
def test_sta_permuted_gate_rejects(tile, window, d, match):
    """Outside its gate B7 raises (on the card; the CPU runs the plain
    version whatever the tile)."""
    with pytest.raises(ValueError, match=match):
        sta.plan_sta_permuted(1, 2, d, (4, 8, 16), tile, window, 64)


def _permuted_kb(grid, tile, window, txt_valid, lt=256):
    """permuted_operands' kb for one batch entry whose first txt_valid of
    lt text keys are unmasked (host numpy), and the tile plan."""
    block = tile[0] * tile[1] * tile[2]
    txt_pad = sta._ceil(lt, block) * block
    tplan = sta.tile_plan(grid, tile, window, txt_pad)
    valid = sta._valid_tokens(grid, tplan["padded_grid"]).reshape(-1)
    img = np.where(valid[tplan["perm"]], 0.0, NEG_INF)
    txt = np.where(np.arange(txt_pad) < txt_valid, 0.0, NEG_INF)
    return np.concatenate([img, txt]).astype(np.float32), tplan, txt_pad


@pytest.mark.parametrize("grid,tile,window", [
    ((5, 9, 13), (2, 4, 8), (3, 3, 3)),
    ((7, 16, 16), (3, 8, 8), (1, 3, 3)),
    ((17, 34, 60), (4, 8, 8), (3, 3, 3)),
])
def test_sta_permuted_walk_covers_the_valid_pairs(grid, tile, window):
    """B7's walk: every query tile's valid rows times the unmasked keys of
    its chunks is the exact pair count of the STA function; no key is
    visited twice; a box all of whose keys are masked is not walked (at
    540p an interior tile takes 27 tiles x 2 boxes and one text box, a tile
    of the last frame row one box of each of its 18 tiles there)."""
    block = tile[0] * tile[1] * tile[2]
    kb, tplan, txt_pad = _permuted_kb(grid, tile, window, 7)
    plan = sta.plan_sta_permuted(1, 1, 128, grid, tile, window, txt_pad)
    rows = sta._tile_rows(grid, tplan)
    pairs = 0
    for qt in range(tplan["n_tiles"]):
        chunks = sta.sta_permuted_walk(plan, block, tplan["nbr"][qt], kb)
        assert all(0 < len(c) <= plan.boxes for c in chunks)
        keys = np.concatenate([np.arange(r, r + plan.rows)
                               for c in chunks for r in c])
        keys = keys[kb[keys] > 0.5 * NEG_INF]
        assert np.unique(keys).size == keys.size
        pairs += int(rows[qt]) * keys.size
    assert pairs == sta.sta_pair_count(grid, tile, window, 7)
    if grid == (17, 34, 60):
        inner = sta.sta_permuted_walk(plan, block,
                                      tplan["nbr"][(1 * 5 + 2) * 8 + 3], kb)
        last = sta.sta_permuted_walk(plan, block,
                                     tplan["nbr"][(4 * 5 + 2) * 8 + 3], kb)
        assert len(inner) == 27 * 2 + 1
        assert len(last) == 9 * 2 + 9 + 1


# B7's emulation cases (grid, tile, window, text keys, valid text keys of
# batch 1): a ragged grid of 64-token tiles, fully masked text boxes, the
# main-path tile whose last frame row has query boxes of pure padding
PERMUTED_EMULATED = [((5, 9, 13), (2, 4, 8), (3, 3, 3), 37, 20),
                     ((4, 8, 16), (2, 4, 8), (1, 3, 3), 160, 5),
                     ((5, 17, 30), (4, 8, 8), (3, 3, 3), 256, 40)]


@pytest.mark.parametrize("case", PERMUTED_EMULATED,
                         ids=["ragged", "masked_txt", "main_tile"])
def test_sta_permuted_emulation_matches_plain(case):
    """B7's walk with its all-masked box skip, the online softmax in walk
    order and zeroed padding rows (sta_permuted_emulate) is the function of
    sta_permuted_plain's running arm (c=None), padding rows included, with
    and without an image key bias; fp32, sums in another order."""
    grid, tile, window, lt, txt_valid = case
    rng = np.random.default_rng(21)
    b, h, d = 2, 2, 64
    s = grid[0] * grid[1] * grid[2]
    img = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32) * 0.5) for _ in range(3)]
    tk, tv = (torch.from_numpy(rng.standard_normal((b, lt, h, d)).astype(
        np.float32) * 0.5) for _ in range(2))
    tb = torch.zeros(b, 1, 1, lt)
    tb[1, ..., txt_valid:] = NEG_INF
    ikb = torch.from_numpy(np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
                           .astype(np.float32))
    for kb_img in (None, ikb):
        _, qp, kcat, vcat, kb = sta.permuted_operands(
            *img, tk, tv, tb, grid, tile, window, kb_img)
        got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile,
                                       window, d ** -0.5)
        want = sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                      d ** -0.5)
        _close(got, want)


def test_sta_permuted_emulation_matches_jax_kernel():
    """The walk against JAX's _sta_kernel in interpret mode (the running
    arm of sta_joint_attention, bound_mode="auto") on a ragged grid of
    64-token tiles, whose key chunks pair two boxes, with an image key
    bias."""
    grid, tile, window, lt, _ = PERMUTED_EMULATED[0]
    img, txt, tb, ikb = _inputs(grid, seed=22, d=64, lt=lt, key_bias=True)
    kw = dict(grid=grid, tile=tile, window=window, bound_mode="auto")
    want, _ = jsta.sta_joint_attention(*_jax(*img, *txt, tb), **kw,
                                       img_key_bias=_jax(ikb)[0])
    iq, ik, iv, _, tk, tv, tbt, kb_img = _torch(*img, *txt, tb, ikb)
    plan, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tbt, grid, tile, window, kb_img)
    got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile, window,
                                   64 ** -0.5)
    _close(sta._unpermute_tokens(got, grid, plan), want)


@pytest.mark.parametrize("quant", [False, True], ids=["static", "int8"])
@pytest.mark.parametrize("case", PERMUTED_EMULATED,
                         ids=["ragged", "masked_txt", "main_tile"])
def test_sta_permuted_static_emulation_matches_plain(case, quant):
    """B6a/B6b's and B6q's walk (sta_permuted_emulate with c: the static
    offset, under quant the codes of tile_codes with each key's own tile's
    scale) is the function of sta_permuted_plain's static arm (and its
    qk_int8 arm), padding rows included, with and without an image key
    bias; fp32, sums in another order."""
    grid, tile, window, lt, txt_valid = case
    rng = np.random.default_rng(23)
    b, h, d = 2, 2, 64
    s = grid[0] * grid[1] * grid[2]
    img = [torch.from_numpy(rng.standard_normal((b, s, h, d)).astype(
        np.float32) * 0.5) for _ in range(3)]
    tk, tv = (torch.from_numpy(rng.standard_normal((b, lt, h, d)).astype(
        np.float32) * 0.5) for _ in range(2))
    tb = torch.zeros(b, 1, 1, lt)
    tb[1, ..., txt_valid:] = NEG_INF
    ikb = torch.from_numpy(np.where(rng.random((b, s)) > 0.2, 0.0, NEG_INF)
                           .astype(np.float32))
    c = torch.tensor([[3.0, 2.5], [2.0, 3.5]])
    for kb_img in (None, ikb):
        _, qp, kcat, vcat, kb = sta.permuted_operands(
            *img, tk, tv, tb, grid, tile, window, kb_img)
        got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile,
                                       window, d ** -0.5, c, quant)
        want = sta.sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                      d ** -0.5, c, qk_int8=quant)
        _close(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["static", "int8"])
@pytest.mark.parametrize("arm", [dict(direct=False), dict(fused=False)],
                         ids=["fused", "unfused"])
def test_sta_permuted_static_emulation_matches_jax_kernel(arm, quant):
    """The static walk against JAX's _sta_nomax_fused_kernel (direct=False)
    and _sta_nomax_kernel (fused=False) in interpret mode, and their
    quant=True arm, through sta_joint_attention(bound_mode="static"), on a
    ragged grid of 64-token tiles, whose key chunks pair two boxes (under
    quant of two tiles with their own scales), with an image key bias; the
    int8 codes agree exactly, so the fp32 tolerance holds."""
    grid, tile, window, lt, _ = PERMUTED_EMULATED[0]
    img, txt, tb, ikb = _inputs(grid, seed=24, d=64, lt=lt, key_bias=True)
    bound = 2.0
    want, _ = jsta.sta_joint_attention(
        *_jax(*img, *txt, tb), grid=grid, tile=tile, window=window,
        bound_mode="static", qk_int8=quant, img_key_bias=_jax(ikb)[0],
        score_bound=jnp.float32(bound), **arm)
    c = torch.full((2, 2), bound * (int8_bound_inflation(64) if quant
                                    else 1.0))
    iq, ik, iv, _, tk, tv, tbt, kb_img = _torch(*img, *txt, tb, ikb)
    plan, qp, kcat, vcat, kb = sta.permuted_operands(
        iq, ik, iv, tk, tv, tbt, grid, tile, window, kb_img)
    got = sta.sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile, window,
                                   64 ** -0.5, c, quant)
    _close(sta._unpermute_tokens(got, grid, plan), want)


def test_sta_permuted_codes_on_cpu_are_tile_codes():
    """B6q's pre-pass wrapper on CPU tensors: tile_codes of qp and kcat in
    the kernel's layout, codes [B, rows, H*D] int8 and scales [B, H,
    tiles]; the text blocks are tiles of their own. Off the CPU it launches
    the kernel or raises."""
    grid, tile, window, lt, _ = PERMUTED_EMULATED[0]
    img, txt, tb, _ = _inputs(grid, seed=25, d=64, lt=lt)
    iq, ik, iv, _, tk, tv, tbt = _torch(*img, *txt, tb)
    _, qp, kcat, _, _ = sta.permuted_operands(iq, ik, iv, tk, tv, tbt, grid,
                                              tile, window)
    q8, k8, sq, sk = sta.sta_permuted_codes(qp.bfloat16(), kcat.bfloat16(),
                                            tile)
    b, s_pad, h, d = qp.shape
    assert q8.dtype == k8.dtype == torch.int8
    assert q8.shape == (b, s_pad, h * d) and sq.shape == (b, h, s_pad // 64)
    assert k8.shape == (b, kcat.shape[1], h * d)
    assert sk.shape == (b, h, kcat.shape[1] // 64)
    for x, codes, scales in ((qp, q8, sq), (kcat, k8, sk)):
        want, want_sc = sta.tile_codes(x.bfloat16(), 64)
        assert torch.equal(codes.float(), want.reshape(codes.shape))
        assert torch.equal(scales, want_sc.permute(0, 2, 1))
    meta = qp.bfloat16().to("meta")   # neither CPU nor CUDA: it raises
    with pytest.raises(ValueError, match="CUDA"):
        sta.sta_permuted_codes(meta, meta, tile)
