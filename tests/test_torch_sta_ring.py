"""The port's STA ring arm (ops/sta.py: the w-major operands, `ring_plan`,
`sta_ring_plain`, the ring gate of `sta_joint_attention` and
`set_sta_ring`) against the JAX package's on the CPU.

The JAX side runs `sta_joint_attention(ring=True)` as tests/test_sta.py
does: its `_sta_ring_kernel` in interpret mode, the text queries through
its chunked attention. The port runs `sta_ring`'s plain version and, for
the text queries, the plain merge over the unpadded keys. Inputs are numpy
draws from a seed, fp32; tolerance `sta_cases._close` (atol 2e-5 times
the output scale, rtol 1e-5: fp32 sums in other orders).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.dit import dit_forward
from hunyuanvideo_efficiency_tpu.ops import sta as jsta
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu_torch.ops import sta
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from test_torch_dit import dit_inputs, make_pair
from sta_cases import NEG_INF, _close, _inputs, _jax, _torch

TILE, WINDOW = (2, 4, 4), (3, 3, 3)
# the ring grids of tests/test_sta.py:496-501
GRIDS = [
    (3, 12, 10),   # ragged t/w, gh = 3 (the ring's minimum)
    (4, 16, 16),   # exact tiling everywhere
    (2, 12, 4),    # gw = 1: the w window fully clamped
    (5, 20, 7),    # ragged h/w, gh = 5, gw = 2
]
GRID_IDS = ["ragged", "exact", "gw1", "gw2"]


@functools.lru_cache(maxsize=None)
def _jax_ring(grid, window, head_block=None, seed=2, tile=TILE, d=32):
    """JAX's ring=True outputs (interpret mode), computed once per case."""
    img, txt, tb, _ = _inputs(grid, seed=seed, d=d)
    out = jsta.sta_joint_attention(*_jax(*img, *txt, tb), grid=grid,
                                   tile=tile, window=window,
                                   bound_mode="static", ring=True,
                                   head_block=head_block)
    return tuple(np.asarray(o) for o in out)


def _port(grid, window, seed=2, **kw):
    img, txt, tb, _ = _inputs(grid, seed=seed)
    return sta.sta_joint_attention(*_torch(*img, *txt, tb), grid=grid,
                                   tile=TILE, window=window,
                                   bound_mode="static", **kw)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_ring_operands_match_jax(grid):
    """The w-major K/V copy and its validity bias, bit for bit."""
    (_, k, _), _, _, _ = _inputs(grid, seed=1)
    pg = sta._padded_grid(grid, TILE)
    got = sta._permute_tokens_cols(torch.from_numpy(k), grid, TILE, pg)
    want = np.asarray(jsta._permute_tokens_cols(jnp.asarray(k), grid, TILE,
                                                pg))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(sta._cols_img_bias(grid, TILE, pg),
                                  jsta._cols_img_bias(grid, TILE, pg))


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_ring_matches_jax(grid):
    """ring=True, image and text outputs, against JAX's ring=True."""
    assert sta.ring_geometry_ok(grid, TILE, WINDOW)
    for g, w in zip(_port(grid, WINDOW, ring=True), _jax_ring(grid, WINDOW)):
        _close(g, w)


def test_ring_matches_jax_masked_oracle_case():
    """The ragged grid with a (1, 3, 3) window of tests/test_sta.py's
    masked-oracle ring test."""
    grid, window = (3, 13, 9), (1, 3, 3)
    for g, w in zip(_port(grid, window, ring=True), _jax_ring(grid, window)):
        _close(g, w)


@pytest.mark.parametrize("head_block", [1, 2])
def test_ring_head_block_matches_jax(head_block):
    """head_block is accepted and does not change the port's result; JAX's
    head groups agree with it."""
    grid = (3, 12, 8)
    got = _port(grid, WINDOW, ring=True, head_block=head_block)
    for g, w in zip(got, _jax_ring(grid, WINDOW, head_block)):
        _close(g, w)


@pytest.mark.parametrize("case", ["gh_below_wh", "img_key_bias"])
def test_ring_gate_falls_back_to_direct(case):
    """Outside the gate (gh = 2 < wh = 3; a caller key bias) ring=True is
    the direct arm, as in JAX: exactly ring=False, and JAX's fallback."""
    grid = (3, 8, 10) if case == "gh_below_wh" else (3, 12, 10)
    img, txt, tb, ikb = _inputs(grid, seed=7,
                                key_bias=case == "img_key_bias")
    kw = dict(grid=grid, tile=TILE, window=WINDOW, bound_mode="static")
    args = _torch(*img, *txt, tb)
    ring = sta.sta_joint_attention(*args, ring=True,
                                   img_key_bias=_torch(ikb)[0], **kw)
    direct = sta.sta_joint_attention(*args, ring=False,
                                     img_key_bias=_torch(ikb)[0], **kw)
    want = jsta.sta_joint_attention(*_jax(*img, *txt, tb), ring=True,
                                    img_key_bias=_jax(ikb)[0], **kw)
    for r, d, w in zip(ring, direct, want):
        torch.testing.assert_close(r, d, rtol=0, atol=0)
        _close(r, w)


@pytest.mark.parametrize("grid,window", [(g, WINDOW) for g in GRIDS]
                         + [((3, 13, 9), (1, 3, 3))],
                         ids=GRID_IDS + ["window133"])
def test_ring_plain_matches_direct_plain(grid, window):
    """sta_ring_plain on the w-major operands computes B4's function:
    sta_attention_plain on the row-major inputs (odd windows)."""
    img, txt, tb, _ = _inputs(grid, seed=3)
    iq, ik, iv, _, tk, tv, tbt = _torch(*img, *txt, tb)
    b, s, h, d = iq.shape
    lt = tk.shape[1]
    c = torch.full((b, h), 3.0)
    scale = d ** -0.5
    pg = sta._padded_grid(grid, TILE)
    out = sta.sta_ring_plain(
        iq.reshape(b, *grid, h * d), sta._permute_tokens_cols(ik, grid, TILE,
                                                              pg),
        sta._permute_tokens_cols(iv, grid, TILE, pg), tk.reshape(b, lt, -1),
        tv.reshape(b, lt, -1), tbt.reshape(b, lt), c, grid, TILE, window,
        scale)
    ref = sta.sta_attention_plain(iq, ik, iv, tk, tv, tbt, grid, TILE, window,
                                  scale, c)
    assert out.shape == (b, *grid, h * d)
    _close(out.reshape(ref.shape), ref)


def test_ring_plan_keys_are_the_tile_plan_neighbours():
    """The valid keys of each query tile under ring_plan are exactly the
    tokens of its tile_plan neighbour tiles, each once (odd window)."""
    grid = (5, 20, 7)
    rows, bias = sta.ring_plan(grid, TILE, WINDOW)
    plan = sta.tile_plan(grid, TILE, WINDOW, 0)
    pg = sta._padded_grid(grid, TILE)
    s = int(np.prod(grid))
    ids = torch.arange(1, s + 1, dtype=torch.float32).reshape(1, s, 1, 1)
    # row-major token of each w-major row, -1 on padding
    token = sta._permute_tokens_cols(ids, grid, TILE, pg)[0].long().numpy()
    token = token[:, 0] - 1
    t, h, w = np.unravel_index(np.arange(s), grid)
    gh, gw = pg[1] // TILE[1], pg[2] // TILE[2]
    tile_of = ((t // TILE[0]) * gh + h // TILE[1]) * gw + w // TILE[2]
    for qt, nb in enumerate(plan["nbr"]):
        got = token[rows[qt][bias[qt] == 0]]
        want = np.flatnonzero(np.isin(tile_of, nb[nb >= 0]))
        np.testing.assert_array_equal(np.sort(got), want)


def test_set_sta_ring_is_the_default_of_ring_none(monkeypatch):
    """ring=None reads the module switch; ring=False overrides it; on CPU
    tensors the wrapper is the plain version and counts no launch."""
    monkeypatch.setattr(sta, "_STA_RING", False)
    grid = GRIDS[0]
    n0 = sta.sta_ring.LAUNCHES
    off = _port(grid, WINDOW)
    sta.set_sta_ring(True)
    assert sta._STA_RING is True
    on = _port(grid, WINDOW)
    forced_off = _port(grid, WINDOW, ring=False)
    for a, b in zip(on, _port(grid, WINDOW, ring=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(forced_off, off):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert sta.sta_ring.LAUNCHES == n0


def test_ring_dit_forward_matches_jax(monkeypatch):
    """A 2+2-block tiny DiT under attn_mode="sta" with QK-norm (the static
    direct arm) with both packages' ring switches on: every STA block takes
    the ring arm on a ragged 3x9x10 patch grid."""
    monkeypatch.setattr(jsta, "_STA_RING", True)
    monkeypatch.setattr(sta, "_STA_RING", True)
    params, jcfg, model = make_pair(
        0, attn_mode="sta", qk_norm=True, sta_tile=TILE, sta_window=WINDOW)
    x, t, txt, mask, txt2 = dit_inputs(1, grid=(3, 18, 20))
    sizes = (3, 9, 10)
    assert sta.ring_geometry_ok(sizes, TILE, WINDOW)
    jc, js = jax_rope(jcfg.rope_dim_list, sizes, theta=jcfg.rope_theta)
    tc, ts = get_nd_rotary_pos_embed(model.cfg.rope_dim_list, sizes,
                                     theta=model.cfg.rope_theta, device="cpu")
    ref = np.asarray(dit_forward(
        params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(txt),
        jnp.asarray(mask), jnp.asarray(txt2), jc, js, cfg=jcfg))
    calls = []
    ring_plain = sta.sta_ring_plain
    monkeypatch.setattr(sta, "sta_ring_plain",
                        lambda *a: calls.append(1) or ring_plain(*a))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(txt), torch.from_numpy(mask),
                    torch.from_numpy(txt2), tc, ts)
    assert len(calls) == 4      # one ring call per STA block
    assert out.shape == ref.shape == x.shape
    scale = np.abs(ref).max()
    assert scale > 1e-2
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4 * scale,
                               rtol=1e-4)


# B10 (csrc/sta_direct.cu, RING): its host plan, walk and emulation. The
# kernel's boxes need tiles of a multiple of 64 tokens, so these cases take
# the ring grids above with 64-token tiles (2 frames of 4 x 8), and D = 64.
TILE64 = (2, 4, 8)


@pytest.mark.parametrize("grid,tile,window", [
    ((17, 34, 60), (4, 8, 8), (3, 3, 3)),
    ((3, 12, 10), TILE64, (3, 3, 3)),
    ((4, 16, 16), TILE64, (2, 2, 2)),
], ids=["540p", "tile64", "even_window"])
def test_plan_sta_ring_is_b4s_launch(grid, tile, window):
    """B10's plan is B4's launch on the same tile (the same block, ring and
    shared memory), for an even window too, which B4 rejects."""
    ring = sta.plan_sta_ring(2, 24, 128, grid, tile, window, 256)
    direct = sta._direct_plan(2, 24, 128, grid, tile, 256, False)
    assert ring == direct and ring.smem <= 232448
    assert (sta.sta_direct_gate(tile, window, 128) is None) == (
        window[0] % 2 == 1)


@pytest.mark.parametrize("grid,tile,window,match", [
    ((3, 8, 10), TILE64, (3, 3, 3), "h-tiles"),      # gh = 2 < wh = 3
    ((3, 12, 10), TILE64, (3, 3, 1), "ww < 2"),
    ((3, 12, 10), TILE, (3, 3, 3), "32 tokens"),
])
def test_sta_ring_gate_rejects(grid, tile, window, match):
    """Outside its gate B10 raises (on the card; the CPU runs the plain
    version)."""
    assert match in sta.sta_ring_gate(grid, tile, window, 64)
    with pytest.raises(ValueError, match=match):
        sta.plan_sta_ring(1, 2, 64, grid, tile, window, 8)


@pytest.mark.parametrize("grid,tile,window", [
    ((3, 12, 10), TILE64, (3, 3, 3)),
    ((5, 20, 7), TILE64, (1, 3, 3)),
    ((4, 16, 16), TILE64, (2, 2, 2)),
    ((17, 34, 60), (4, 8, 8), (3, 3, 3)),
])
def test_sta_ring_walk_covers_the_valid_pairs(grid, tile, window):
    """B10's walk: each box's kp/vp rows hold the tokens of its box in the
    w-major order; each query tile's walked tokens are exactly ring_plan's
    valid keys, each once (even windows included); for odd windows the
    pairs are the STA function's count; at 540p an interior tile takes 27
    tiles x 2 boxes and a tile of the last frame row 27 boxes."""
    plan = sta.plan_sta_ring(1, 1, 128, grid, tile, window, 7)
    rows, bias = sta.ring_plan(grid, tile, window)
    pg = sta._padded_grid(grid, tile)
    s = int(np.prod(grid))
    ids = torch.arange(1, s + 1, dtype=torch.float32).reshape(1, s, 1, 1)
    token = sta._permute_tokens_cols(ids, grid, tile, pg)[0, :, 0].long()
    token = token.numpy() - 1          # the token of each w-major row
    pairs, n_tiles = 0, plan.blocks[0] // plan.subs
    for qt in range(n_tiles):
        chunks = sta.sta_ring_walk(grid, tile, window, plan, qt)
        assert all(0 < len(c) <= plan.boxes for c in chunks)
        keys = []
        for kt, sub, row in (box for c in chunks for box in c):
            tok = sta.sta_box_tokens(grid, tile, plan, kt, sub)
            np.testing.assert_array_equal(
                np.where(tok >= 0, tok, -1),
                token[row:row + plan.rows])
            keys.append(tok[tok >= 0])
        keys = np.concatenate(keys)
        assert np.unique(keys).size == keys.size
        np.testing.assert_array_equal(
            np.sort(keys), np.sort(token[rows[qt][bias[qt] == 0]]))
        q_rows = sum(int((sta.sta_box_tokens(grid, tile, plan, qt, sub)
                          >= 0).sum()) for sub in range(plan.subs))
        pairs += q_rows * (keys.size + 7)
    if window[0] % 2:
        assert pairs == sta.sta_pair_count(grid, tile, window, 7)
    if grid == (17, 34, 60):
        walk = functools.partial(sta.sta_ring_walk, grid, tile, window, plan)
        assert sum(map(len, walk((1 * 5 + 2) * 8 + 3))) == 54
        assert sum(map(len, walk((4 * 5 + 2) * 8 + 3))) == 27


def _ring_args(grid, window, seed, tile=TILE64, d=64, lt=24):
    """sta_ring's operands from _inputs (fp32): q5, the w-major kp/vp, the
    flattened text and its bias, the offset c and the scale."""
    img, txt, tb, _ = _inputs(grid, seed=seed, d=d, lt=lt)
    iq, ik, iv, _, tk, tv, tbt = _torch(*img, *txt, tb)
    b, _, h, _ = iq.shape
    pg = sta._padded_grid(grid, tile)
    return (iq.reshape(b, *grid, h * d),
            sta._permute_tokens_cols(ik, grid, tile, pg),
            sta._permute_tokens_cols(iv, grid, tile, pg),
            tk.reshape(b, lt, -1), tv.reshape(b, lt, -1), tbt.reshape(b, lt),
            torch.full((b, h), 3.0), grid, tile, window, d ** -0.5)


@pytest.mark.parametrize("grid,window", [(g, WINDOW) for g in GRIDS]
                         + [((4, 16, 16), (2, 2, 2))],
                         ids=GRID_IDS + ["even_window"])
def test_sta_ring_emulation_matches_plain(grid, window):
    """B10's walk with zero-filled boxes and the geometry bias
    (sta_ring_emulate) is sta_ring_plain's function on the ring grids, a
    text key bias masking some keys, for an even window too; fp32, sums in
    another order."""
    args = _ring_args(grid, window, seed=23)
    args[5][1, 5:] = NEG_INF
    _close(sta.sta_ring_emulate(*args), sta.sta_ring_plain(*args))


@pytest.mark.parametrize("grid", [GRIDS[0], GRIDS[3]],
                         ids=[GRID_IDS[0], GRID_IDS[3]])
def test_sta_ring_emulation_matches_jax_kernel(grid):
    """The walk against JAX's _sta_ring_kernel in interpret mode
    (sta_joint_attention(ring=True), its Cauchy-Schwarz offset: the
    static bound only shifts the exponent, so the port's formula of it
    serves) on two ragged ring grids."""
    want, _ = _jax_ring(grid, WINDOW, tile=TILE64, d=64)
    img, txt, tb, _ = _inputs(grid, seed=2, d=64)
    iq, ik, iv, _, tk, tv, tbt = _torch(*img, *txt, tb)
    b, _, h, d = iq.shape
    lt = tk.shape[1]
    norm = lambda x: x.square().sum(-1).sqrt().amax(dim=1)  # noqa: E731
    c = norm(iq) * torch.maximum(norm(ik), norm(tk)) * d ** -0.5
    pg = sta._padded_grid(grid, TILE64)
    got = sta.sta_ring_emulate(
        iq.reshape(b, *grid, h * d),
        sta._permute_tokens_cols(ik, grid, TILE64, pg),
        sta._permute_tokens_cols(iv, grid, TILE64, pg), tk.reshape(b, lt, -1),
        tv.reshape(b, lt, -1), tbt.reshape(b, lt), c, grid, TILE64, WINDOW,
        d ** -0.5)
    _close(got.reshape(want.shape), want)
