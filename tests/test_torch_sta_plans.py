"""The host side of the port's STA kernels on the CPU (ops/sta.py): the
dispatch and its rejections, the wrappers' plain versions on CPU tensors,
the pair count, and the kernels' host plans (`plan_sta_direct`,
`plan_sta_permuted`), gates and walks over key boxes pinned. Inputs and
tolerance as in tests/sta_cases.py.
"""
import dataclasses

import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu_torch.ops import sta
from hunyuanvideo_efficiency_tpu_torch.ops.attention import (attention,
                                                             joint_attention)
from sta_cases import GEOMETRIES, NEG_INF, _inputs, _torch


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
