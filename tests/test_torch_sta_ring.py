"""The port's STA ring arm (ops/sta.py: the w-major operands, `ring_plan`,
`sta_ring_plain`, the ring gate of `sta_joint_attention` and
`set_sta_ring`) against the JAX package's on the CPU.

The JAX side runs `sta_joint_attention(ring=True)` as tests/test_sta.py
does: its `_sta_ring_kernel` in interpret mode, the text queries through
its chunked attention. The port runs `sta_ring`'s plain version and, for
the text queries, the plain merge over the unpadded keys. Inputs are numpy
draws from a seed, fp32; tolerance `test_torch_sta._close` (atol 2e-5 times
the output scale, rtol 1e-5: fp32 sums in other orders).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuanvideo_efficiency_tpu.models.dit import dit_forward
from hunyuanvideo_efficiency_tpu.ops import sta as jsta
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu_torch.ops import sta
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from test_torch_dit import dit_inputs, make_pair
from test_torch_sta import _close, _inputs, _jax, _torch

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
def _jax_ring(grid, window, head_block=None, seed=2):
    """JAX's ring=True outputs (interpret mode), computed once per case."""
    img, txt, tb, _ = _inputs(grid, seed=seed)
    out = jsta.sta_joint_attention(*_jax(*img, *txt, tb), grid=grid,
                                   tile=TILE, window=window,
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
