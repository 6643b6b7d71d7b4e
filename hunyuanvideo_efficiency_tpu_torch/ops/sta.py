"""Sliding Tile Attention (STA) for the image queries of the joint [img | txt]
sequence (JAX counterpart: ops/sta.py).

Video tokens of a (T, H, W) patch grid are cut into (tt, th, tw) tiles; the
queries of a tile attend to the image keys of the tiles inside a sliding
window of tiles around it, plus every text key. Text queries keep full
attention over [img | txt]. The tile plan (`tile_plan`) is host numpy,
static per (grid, tile, window), and equal to the JAX package's.

Six kernels, each a wrapper here with a `LAUNCHES` count and, under a
profiler, a span of its name (utils/profiling.py:span):

* `sta_direct` (B4, `csrc/sta_direct.cu`, QUANT=0) replaces
  `_sta_nomax_direct_kernel`: static exponent offset C, q/k/v read and out
  written in the row-major token grid through 5-D TMA maps, text keys
  folded last; wgmma products on a TMA ring (`plan_sta_direct` describes
  the launch on the host, `sta_direct_emulate` its walk over key boxes).
  The main path's kernel under QK-norm.
* `sta_direct_int8` (B4q, the same source with QUANT=1) is its `quant=True`
  arm (`--attn-mode sta_int8`): a pre-pass (`sta_tile_codes`) writes int8
  codes of q and k in the row-major grid with one scale per (batch, head,
  tile), then the image keys' Q.K^T runs on s8 wgmma and the text keys'
  in the input type.
* `sta_ring` (B10, `csrc/sta_direct.cu`, RING=1) replaces
  `_sta_ring_kernel`: B4's function with the image keys read from w-major
  copies as whole window-column runs, validity from the geometry; B4's
  loop and query side (`plan_sta_ring`, `sta_ring_walk`,
  `sta_ring_emulate`).
* `sta_permuted_static` (B6a/B6b, `csrc/sta_permuted.cu`, RUNNING=0)
  replaces `_sta_nomax_fused_kernel` and `_sta_nomax_kernel`, which
  compute the same function: static offset over tile-major permuted q and
  the concatenated [img tiles | text] keys `kcat`, the text block(s) being
  extra slots of the neighbour table; wgmma products on a TMA ring over
  the neighbour table's key boxes (`plan_sta_permuted`,
  `sta_permuted_walk`, `sta_permuted_emulate`).
* `sta_permuted_running` (B7, the same source, RUNNING=1) replaces
  `_sta_kernel`: the same layout and walk with a running max, for models
  without QK-norm.
* `sta_permuted_static_int8` (B6q, the same source, QUANT=1) is the
  `quant=True` arm of the permuted static kernels: a pre-pass
  (`sta_permuted_codes`) writes int8 codes of qp and kcat with one scale
  per (batch, head, tile), text blocks included, then every chunk's Q.K^T
  runs on s8 wgmma. The direct and permuted int8 arms compute different
  functions, and each wrapper follows its JAX arm.

On CPU tensors each wrapper runs the plain version (`sta_attention_plain`,
built on `sta_permuted_plain`; B10's `sta_ring_plain`): neighbour tiles gathered per chunk of query
tiles, fp32 scores from the model-dtype inputs (or exact int8 products
times sq*sk*scale), p rounded to V's type before P.V, the static arm
exp(s*scale + kb - C) with max(l, 1e-37) and the running arm an exact
softmax. On any other device a wrapper launches its kernel or raises.

Training: `sta_joint_attention_trainable` keeps the kernel forward and
takes its gradients from autograd through `sta_gathered_attention`, the
differentiable gathered form (the JAX package has no Pallas kernel in this
backward either).

Bound on the H100: 4*D per valid query-key pair on the tensor cores; with
a 3x3x3 window of 256-token tiles each query sees up to 6,912 image keys,
far above the bytes of q/k/v/out, so the kernels are bound by operations.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import cuda_lib
from .flash_attention import (_DTYPE_CODE, _as_rows, flash_attention,
                              int8_bound_inflation, merge_flash_states)
from .flash_backward import tma_view_error
from ..utils.profiling import span

NEG_INF = -1e30
PLAIN_TILE_CHUNK = 8   # query tiles per step of the plain version: at 540p
                       # (24 heads) its scores take ~3 GB per step
STA_CHUNK = 128        # B4's keys a ring slot, and its most query rows a block


# --------------------------------------------------------------------------
# tile geometry (host-side, static per resolution)
# --------------------------------------------------------------------------

def _ceil(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=64)
def tile_plan(grid: Tuple[int, int, int], tile: Tuple[int, int, int],
              window: Tuple[int, int, int], txt_pad: int):
    """Static STA plan for a (T, H, W) token grid.

    Returns dict with:
      perm / inv_perm: token permutation row-major -> tile-major (padded)
      nbr:   [n_tiles, n_slots] int32 -- key BLOCK index per slot; the img
             tiles come first, the text block(s) last; -1 = skip
      n_tiles, s_img_pad, tokens_per_tile
    """
    t, h, w = grid
    tt, th, tw = tile
    gt, gh, gw = _ceil(t, tt), _ceil(h, th), _ceil(w, tw)
    tp, hp, wp = gt * tt, gh * th, gw * tw
    n_tiles = gt * gh * gw
    tokens_per_tile = tt * th * tw

    idx = np.arange(tp * hp * wp, dtype=np.int32).reshape(tp, hp, wp)
    tiles = idx.reshape(gt, tt, gh, th, gw, tw).transpose(0, 2, 4, 1, 3, 5)
    perm = tiles.reshape(-1)  # tile-major -> padded-row-major src index
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(perm.size, dtype=np.int32)

    wt, wh, ww = window
    n_img_slots = wt * wh * ww
    n_txt_blocks = _ceil(txt_pad, tokens_per_tile)
    n_slots = n_img_slots + n_txt_blocks
    nbr = np.full((n_tiles, n_slots), -1, np.int32)
    coords = np.stack(np.meshgrid(np.arange(gt), np.arange(gh),
                                  np.arange(gw), indexing="ij"),
                      -1).reshape(-1, 3)
    for i, (a, b, c) in enumerate(coords):
        s = 0
        for da in range(-(wt // 2), wt // 2 + 1):
            for db in range(-(wh // 2), wh // 2 + 1):
                for dc in range(-(ww // 2), ww // 2 + 1):
                    aa, bb, cc = a + da, b + db, c + dc
                    if 0 <= aa < gt and 0 <= bb < gh and 0 <= cc < gw:
                        nbr[i, s] = (aa * gh + bb) * gw + cc
                    s += 1
        for jblk in range(n_txt_blocks):
            nbr[i, n_img_slots + jblk] = n_tiles + jblk
    # valid-first compaction: slot order is irrelevant to the math (slots
    # fold commutatively under one softmax); the kernels still test every
    # slot for -1 rather than stopping at the first one
    order = np.argsort(nbr < 0, axis=1, kind="stable")
    nbr = np.take_along_axis(nbr, order, axis=1)
    return {
        "perm": perm, "inv_perm": inv_perm, "nbr": nbr,
        "n_tiles": n_tiles, "tokens_per_tile": tokens_per_tile,
        "padded_grid": (tp, hp, wp), "n_slots": n_slots, "tile": tile,
    }


def _valid_tokens(grid, padded_grid) -> np.ndarray:
    """[Tp, Hp, Wp] bool: the tokens of the padded grid that exist."""
    valid = np.zeros(padded_grid, bool)
    valid[:grid[0], :grid[1], :grid[2]] = True
    return valid


def _permute_tokens(x, grid, tile, plan):
    """[B, S_img, H, D] row-major -> [B, S_pad, H, D] tile-major, zero-padded
    (pad + reshape + transpose; the tiling permutation is regular)."""
    b, s, hh, d = x.shape
    tp, hp, wp = plan["padded_grid"]
    t, h, w = grid
    tt, th, tw = tile
    xg = _pad_tokens_5d(x, grid, (tp, hp, wp))
    xg = xg.reshape(b, tp // tt, tt, hp // th, th, wp // tw, tw, hh * d)
    xg = xg.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return xg.reshape(b, tp * hp * wp, hh, d)


def _pad_tokens_5d(x, grid, padded_grid):
    """[B, S_img, H, D] row-major -> [B, Tp, Hp, Wp, H*D] zero-padded."""
    b, s, hh, d = x.shape
    t, h, w = grid
    tp, hp, wp = padded_grid
    xg = x.reshape(b, t, h, w, hh * d)
    if (tp, hp, wp) == (t, h, w):
        return xg
    return torch.nn.functional.pad(xg, (0, 0, 0, wp - w, 0, hp - h,
                                        0, tp - t))


def _unpermute_tokens(y, grid, plan, tile=None):
    """[B, S_pad, HD] tile-major -> [B, S_img, HD] row-major (inverse of
    _permute_tokens)."""
    b, sp, hd = y.shape
    tp, hp, wp = plan["padded_grid"]
    t, h, w = grid
    tt, th, tw = plan["tile"] if tile is None else tile
    yg = y.reshape(b, tp // tt, hp // th, wp // tw, tt, th, tw, hd)
    yg = yg.permute(0, 1, 4, 2, 5, 3, 6, 7)
    xg = yg.reshape(b, tp, hp, wp, hd)
    return xg[:, :t, :h, :w].reshape(b, t * h * w, hd)


def sta_reference_mask(grid, tile, window, s_img):
    """Dense boolean mask [S_img, S_img] equivalent to the STA pattern
    (oracle for tests): q attends k iff their tiles are within the window.
    Built from the [n_tiles, n_tiles] tile mask, so no [S, S, 3] temporary
    exists."""
    t, h, w = grid
    tt, th, tw = tile
    wt, wh, ww = window
    gh, gw = _ceil(h, th), _ceil(w, tw)
    coords = np.stack(np.meshgrid(np.arange(t), np.arange(h), np.arange(w),
                                  indexing="ij"), -1).reshape(-1, 3)
    tiles = coords // np.array([tt, th, tw])
    tile_id = (tiles[:, 0] * gh + tiles[:, 1]) * gw + tiles[:, 2]
    tc = np.stack(np.meshgrid(np.arange(_ceil(t, tt)), np.arange(gh),
                              np.arange(gw), indexing="ij"), -1).reshape(-1, 3)
    half = np.array([wt // 2, wh // 2, ww // 2])
    tmask = (np.abs(tc[:, None, :] - tc[None, :, :]) <= half).all(-1)
    if s_img != tile_id.size:
        raise ValueError(f"{s_img} image tokens for grid {grid}")
    return tmask[tile_id[:, None], tile_id[None, :]]


def _padded_grid(grid, tile):
    return tuple(_ceil(n, k) * k for n, k in zip(grid, tile))


def _permute_tokens_cols(x, grid, tile, padded_grid):
    """[B, S_img, H, D] row-major -> [B, S_pad, H*D] zero-padded, in w-MAJOR
    tile order (tile index s = (c*gt + a)*gh + b): one window column of a
    query tile, the tiles (a + da, wh rows from the clamped start, c), is
    wt contiguous runs of wh tiles (the ring kernel's operand layout)."""
    b, s, hh, d = x.shape
    tp, hp, wp = padded_grid
    tt, th, tw = tile
    xg = _pad_tokens_5d(x, grid, padded_grid)
    xg = xg.reshape(b, tp // tt, tt, hp // th, th, wp // tw, tw, hh * d)
    xg = xg.permute(0, 5, 1, 3, 2, 4, 6, 7)   # b, gw, gt, gh, tt, th, tw
    return xg.reshape(b, tp * hp * wp, hh * d)


def _cols_img_bias(grid, tile, padded_grid) -> np.ndarray:
    """Token validity (0 / NEG_INF) over the w-major order of
    `_permute_tokens_cols`, [S_pad] fp32 (host numpy)."""
    t, h, w = grid
    tt, th, tw = tile
    tp, hp, wp = padded_grid
    v = np.zeros((tp, hp, wp), np.float32)
    v[:t, :h, :w] = 1.0
    v = v.reshape(tp // tt, tt, hp // th, th, wp // tw, tw)
    v = v.transpose(4, 0, 2, 1, 3, 5).reshape(-1)
    return np.where(v > 0, 0.0, NEG_INF).astype(np.float32)


def ring_geometry_ok(grid, tile, window) -> bool:
    """The ring kernel's geometry gate (JAX sta.py:1454-1463): at least wh
    tile rows for the clamped h-runs, and a window at least 2 columns
    wide."""
    gh = _ceil(grid[1], tile[1])
    return gh >= window[1] and window[2] >= 2


@functools.lru_cache(maxsize=16)
def ring_plan(grid, tile, window):
    """The key set of each query tile under the ring kernel (host numpy):
    for query tile (a, bh, cw) in row-major tile order, its window columns
    cw + dc, each as wt runs (da) of wh tiles from the clamped start
    sb = clip(bh - wh//2, 0, gh - wh). Returns the w-major row of every key
    [n_tiles, ncol*wt*wh*block] (int64; out-of-range runs clamped to a real
    one) and its bias (0, or NEG_INF outside the h-window, beyond the grid
    in t or in columns, or on a padding token), the validity of JAX's
    `col_bias` (sta.py:1048-1073)."""
    t, h, w = grid
    tt, th, tw = tile
    wt, wh, ww = window
    gt, gh, gw = _ceil(t, tt), _ceil(h, th), _ceil(w, tw)
    block = tt * th * tw
    a, bh, cw = (x.reshape(-1, 1, 1, 1, 1) for x in np.meshgrid(
        np.arange(gt), np.arange(gh), np.arange(gw), indexing="ij"))
    dc = np.arange(-(ww // 2), ww // 2 + 1).reshape(1, -1, 1, 1, 1)
    da = np.arange(wt).reshape(1, 1, -1, 1, 1)
    r = np.arange(wh).reshape(1, 1, 1, -1, 1)
    tok = np.arange(block).reshape(1, 1, 1, 1, -1)
    cc, aa = cw + dc, a + da - wt // 2
    bb = np.clip(bh - wh // 2, 0, gh - wh) + r
    rows = ((np.clip(cc, 0, gw - 1) * gt + np.clip(aa, 0, gt - 1)) * gh
            + bb) * block + tok
    ok = ((cc >= 0) & (cc < gw) & (aa >= 0) & (aa < gt)
          & (np.abs(bb - bh) <= wh // 2))
    tok_bias = _cols_img_bias(grid, tile, _padded_grid(grid, tile))
    bias = np.where(ok, tok_bias[rows], NEG_INF).astype(np.float32)
    n = gt * gh * gw
    return rows.reshape(n, -1), bias.reshape(n, -1)


def _tile_rows(grid, plan) -> np.ndarray:
    """Valid tokens of each tile, [n_tiles] (host numpy)."""
    valid = _valid_tokens(grid, plan["padded_grid"]).reshape(-1)
    return valid[plan["perm"]].reshape(plan["n_tiles"], -1).sum(1)


def sta_pair_count(grid, tile, window, txt_valid: int) -> int:
    """Query-key pairs the STA function needs, per (batch, head): for each
    query tile, its valid rows times the valid keys of its valid neighbour
    tiles plus `txt_valid` text keys."""
    plan = tile_plan(tuple(grid), tuple(tile), tuple(window), 0)
    rows = _tile_rows(grid, plan)
    nbr = plan["nbr"]
    keys = np.where(nbr >= 0, rows[np.maximum(nbr, 0)], 0).sum(1)
    return int((rows * (keys + txt_valid)).sum())


def _box_gate(tile, d: int) -> Optional[str]:
    """Why csrc/sta_direct.cu cannot cut a tile into TMA boxes, or None:
    head_dim 64 or 128; tile tokens a multiple of 64 and of R = min(128,
    tokens), the tokens of a box; the box whole (h, w) planes (th*tw
    divides R) or whole rows of one plane (R divides th*tw and tw divides
    R)."""
    tt, th, tw = tile
    block, plane = tt * th * tw, th * tw
    rows = min(STA_CHUNK, block)
    if d not in (64, 128):
        return f"head_dim {d} is not 64 or 128"
    if block <= 0 or block % 64 or block % rows:
        return f"tile {tuple(tile)} has {block} tokens: not 64 or a " \
               f"multiple of 128"
    if rows % plane and (plane % rows or rows % tw):
        return (f"tile {tuple(tile)}: {rows} tokens are neither whole "
                f"{th}x{tw} planes nor whole rows of one")
    return None


def sta_direct_gate(tile, window, d: int) -> Optional[str]:
    """Why B4 (csrc/sta_direct.cu) cannot take a geometry, or None: the
    tile's TMA boxes (`_box_gate`) and an odd window."""
    err = _box_gate(tile, d)
    if err:
        return err
    if any(x % 2 == 0 for x in window):
        return f"window {tuple(window)} is not odd"
    return None


def sta_ring_gate(grid, tile, window, d: int) -> Optional[str]:
    """Why B10 (csrc/sta_direct.cu, RING) cannot take a geometry, or None:
    the tile's TMA boxes (`_box_gate`) and the ring gate
    (`ring_geometry_ok`: at least wh tile rows, ww >= 2); any window
    parity."""
    err = _box_gate(tile, d)
    if err:
        return err
    if not ring_geometry_ok(grid, tile, window):
        return (f"grid {tuple(grid)} with tile {tuple(tile)} has fewer "
                f"h-tiles than window {tuple(window)} needs, or ww < 2")
    return None


@dataclasses.dataclass(frozen=True)
class StaDirectPlan:
    """B4's launch (csrc/sta_direct.cu) on one geometry: `rows` tokens of a
    tile a TMA box (a block's query rows), the box as (frames, rows,
    columns) of the tile, `subs` boxes a tile, `boxes` boxes a key chunk of
    STA_CHUNK, the launch grid (box of a query tile fastest, then heads,
    batch), the keys of a text chunk (B4q: 64, so that its bf16 K fits
    where an image chunk's int8 K goes) and the text's chunks, the ring's
    slots and the dynamic shared memory in bytes (Q, under QUANT also its
    int8 codes; per slot K, V, the per-key bias (QUANT with a factor) and
    the chunk's boxes; the barriers; per warp a count of key boxes and the
    last unmasked text key; 1024 to align). The kernel walks the text
    chunks up to the last one holding an unmasked key (masked keys add
    nothing), at most `txt_chunks`."""
    rows: int
    box: Tuple[int, int, int]
    subs: int
    boxes: int
    blocks: Tuple[int, int, int]
    txt_keys: int
    txt_chunks: int
    stages: int
    smem: int


def plan_sta_direct(b: int, heads: int, d: int, grid, tile, window,
                    lt: int, quant: bool = False) -> StaDirectPlan:
    """The plan of B4 (quant: B4q) for [b, T*Hg*Wg, heads, d] queries over
    `grid` and lt text keys; raises ValueError outside its gate."""
    err = sta_direct_gate(tile, window, d)
    if err:
        raise ValueError(f"sta_direct: {err}")
    return _direct_plan(b, heads, d, grid, tile, lt, quant)


def plan_sta_ring(b: int, heads: int, d: int, grid, tile, window,
                  lt: int) -> StaDirectPlan:
    """The plan of B10 (B4's launch, block and ring; its key boxes are R
    contiguous rows of the w-major kp/vp); raises ValueError outside
    `sta_ring_gate`."""
    err = sta_ring_gate(grid, tile, window, d)
    if err:
        raise ValueError(f"sta_ring: {err}")
    return _direct_plan(b, heads, d, grid, tile, lt, False)


def _direct_plan(b, heads, d, grid, tile, lt, quant) -> StaDirectPlan:
    tt, th, tw = tile
    block, plane = tt * th * tw, th * tw
    rows = min(STA_CHUNK, block)
    box = (rows // plane, th, tw) if rows % plane == 0 else (1, rows // tw,
                                                              tw)
    n_tiles = int(np.prod([_ceil(n, k) for n, k in zip(grid, tile)]))
    stages = 3
    # a slot: K (int8 codes, or a 64-key text chunk's bf16 K, under quant),
    # V, and per key the bias (quant: with a factor)
    slot = STA_CHUNK * d * (3 if quant else 4) + STA_CHUNK * (8 if quant
                                                              else 4)
    smem = (STA_CHUNK * d * (3 if quant else 2) + stages * (slot + 32)
            + (1 + 3 * stages) * 8 + 2 * (384 // 32) * 4 + 1024)
    txt_keys = 64 if quant else STA_CHUNK
    subs = block // rows
    return StaDirectPlan(rows, box, subs, STA_CHUNK // rows,
                         (n_tiles * subs, heads, b), txt_keys,
                         _ceil(lt, txt_keys), stages, smem)


def sta_grid_map(grid, plan: StaDirectPlan, b: int, cols: int,
                 row_stride: int, batch_stride: int, itemsize: int,
                 box_cols: int = 64):
    """B4's 5-D TMA map over a [b, T*Hg*Wg, cols] grid operand (strides in
    elements): dims innermost first (cols, Wg, Hg, T, b), the byte strides
    of the outer four, and the box (box_cols, bw, bh, bt, 1)."""
    t, hg, wg = grid
    if b == 1:
        batch_stride = row_stride * t * hg * wg
    dims = (cols, wg, hg, t, b)
    strides = tuple(x * itemsize for x in (
        row_stride, row_stride * wg, row_stride * wg * hg, batch_stride))
    bt, bh, bw = plan.box
    return dims, strides, (box_cols, bw, bh, bt, 1)


def _box_origin(tile, rows, a, bb, cc, sub):
    """The first token (t, h, w) of box `sub` of tile (a, bb, cc), boxes of
    `rows` tokens."""
    tt, th, tw = tile
    f0 = sub * rows
    return a * tt + f0 // (th * tw), bb * th + (f0 // tw) % th, cc * tw


def sta_box_tokens(grid, tile, plan: StaDirectPlan, tile_idx: int,
                   sub: int) -> np.ndarray:
    """The row-major token of each of the box's rows, -1 past the grid (the
    rows TMA zero-fills), [rows] int64."""
    t, hg, wg = grid
    gh, gw = _ceil(hg, tile[1]), _ceil(wg, tile[2])
    t0, h0, w0 = _box_origin(tile, plan.rows, tile_idx // (gh * gw),
                             (tile_idx // gw) % gh, tile_idx % gw, sub)
    _, bh, bw = plan.box
    r = np.arange(plan.rows)
    tt_, hh, ww = t0 + r // (bh * bw), h0 + (r // bw) % bh, w0 + r % bw
    tok = (tt_ * hg + hh) * wg + ww
    return np.where((tt_ < t) & (hh < hg) & (ww < wg), tok, -1)


def sta_walk(grid, tile, window, plan: StaDirectPlan,
             qtile: int) -> List[List[Tuple[int, int]]]:
    """B4's image key chunks of query tile `qtile`, as the kernel walks
    them: the window's tiles in tile_plan's slot order, each tile's boxes
    (tile, sub) in turn, a box whose first token lies past the grid
    skipped, `plan.boxes` boxes a chunk (the last chunk may be short: the
    kernel loads its first box again there, masked). The text chunks
    follow."""
    t, hg, wg = grid
    tt, th, tw = tile
    wt, wh, ww = window
    gt, gh, gw = _ceil(t, tt), _ceil(hg, th), _ceil(wg, tw)
    qa, qb, qc = qtile // (gh * gw), (qtile // gw) % gh, qtile % gw
    boxes = []
    for s in range(wt * wh * ww):
        a = qa + s // (wh * ww) - wt // 2
        bb = qb + (s // ww) % wh - wh // 2
        cc = qc + s % ww - ww // 2
        if not (0 <= a < gt and 0 <= bb < gh and 0 <= cc < gw):
            continue
        for sub in range(plan.subs):
            t0, h0, _ = _box_origin(tile, plan.rows, a, bb, cc, sub)
            if t0 < t and h0 < hg:
                boxes.append(((a * gh + bb) * gw + cc, sub))
    return [boxes[i:i + plan.boxes] for i in range(0, len(boxes), plan.boxes)]


def sta_ring_walk(grid, tile, window, plan: StaDirectPlan,
                  qtile: int) -> List[List[Tuple[int, int, int]]]:
    """B10's image key chunks of row-major query tile `qtile`, as the kernel
    walks them: ring_plan's slot order (window column, run, tile of the run
    from the clamped start, a tile outside the h-window skipped), each
    tile's boxes (row-major tile, sub, first row in the w-major kp/vp) in
    turn, a box whose first token lies past the grid skipped, `plan.boxes`
    boxes a chunk (a short last chunk loads its first box again,
    masked)."""
    t, hg, wg = grid
    tt, th, tw = tile
    wt, wh, ww = window
    gt, gh, gw = _ceil(t, tt), _ceil(hg, th), _ceil(wg, tw)
    qa, qb, qc = qtile // (gh * gw), (qtile // gw) % gh, qtile % gw
    sb = min(max(qb - wh // 2, 0), gh - wh)
    boxes = []
    for dc in range(2 * (ww // 2) + 1):
        cc = qc + dc - ww // 2
        for da in range(wt):
            a = qa + da - wt // 2
            for r in range(wh):
                bb = sb + r
                if not (0 <= cc < gw and 0 <= a < gt) \
                        or abs(bb - qb) > wh // 2:
                    continue
                for sub in range(plan.subs):
                    t0, h0, _ = _box_origin(tile, plan.rows, a, bb, cc, sub)
                    if t0 < t and h0 < hg:
                        row = (((cc * gt + a) * gh + bb) * plan.subs
                               + sub) * plan.rows
                        boxes.append(((a * gh + bb) * gw + cc, sub, row))
    return [boxes[i:i + plan.boxes] for i in range(0, len(boxes), plan.boxes)]


PERMUTED_MAX_BOXES = 1024  # the permuted kernels' marks of live key boxes
                           # a query tile


@dataclasses.dataclass(frozen=True)
class StaPermutedPlan:
    """The launch of the permuted kernels B7, B6a/B6b and B6q
    (csrc/sta_permuted.cu) on one geometry: `rows` rows of a tile a TMA box
    (a block's query rows: 128, or 64 when the tile's tokens are not a
    multiple of 128), `subs` boxes a tile, `boxes` boxes a key chunk of
    STA_CHUNK, `n_boxes` key boxes a query tile (slots x subs, each marked
    live or not before the walk), the launch grid (box of a query tile
    fastest, then heads, batch), the ring's slots and the dynamic shared
    memory in bytes (Q, or B6q's int8 codes of Q; per slot K (B6q: int8
    codes), V, the per-key bias (B6q: (factor, bias) pairs) and the chunk's
    box rows; the barriers; the marks; 1024 to align)."""
    rows: int
    subs: int
    boxes: int
    n_boxes: int
    blocks: Tuple[int, int, int]
    stages: int
    smem: int


def sta_permuted_gate(tile, n_slots: int, d: int) -> Optional[str]:
    """Why the permuted kernels (csrc/sta_permuted.cu) cannot take a
    geometry, or None: head_dim 64 or 128, tile tokens a multiple of 64, at
    most PERMUTED_MAX_BOXES key boxes a query tile. The box limit is far
    above any window the CLI gives: a 3x3x3 window of 256-token tiles with
    one text block is 55 boxes."""
    block = tile[0] * tile[1] * tile[2]
    if d not in (64, 128):
        return f"head_dim {d} is not 64 or 128"
    if block <= 0 or block % 64:
        return f"tile {tuple(tile)} has {block} tokens, not a multiple of 64"
    rows = STA_CHUNK if block % STA_CHUNK == 0 else 64
    if n_slots * (block // rows) > PERMUTED_MAX_BOXES:
        return (f"{n_slots} slots of {block // rows} boxes exceed "
                f"{PERMUTED_MAX_BOXES} key boxes")
    return None


def plan_sta_permuted(b: int, heads: int, d: int, grid, tile, window,
                      txt_pad: int, quant: bool = False,
                      name: str = "sta_permuted") -> StaPermutedPlan:
    """The plan of the permuted kernels for tile-major [b, S_pad, heads, d]
    queries over `grid` with txt_pad padded text keys (whole tiles); quant:
    B6q's. Raises ValueError, naming the caller `name`, outside
    `sta_permuted_gate`."""
    plan = tile_plan(tuple(grid), tuple(tile), tuple(window), txt_pad)
    err = sta_permuted_gate(tile, plan["n_slots"], d)
    if err:
        raise ValueError(f"{name}: {err}")
    block = plan["tokens_per_tile"]
    rows = STA_CHUNK if block % STA_CHUNK == 0 else 64
    stages, subs = 3, block // rows
    qk_bytes, w_bytes = (1, 8) if quant else (2, 4)   # Q and K; per key
    slot = STA_CHUNK * d * (qk_bytes + 2) + STA_CHUNK * w_bytes + 8
    smem = (STA_CHUNK * d * qk_bytes + stages * slot + (1 + 3 * stages) * 8
            + PERMUTED_MAX_BOXES // 8 + 1024)
    return StaPermutedPlan(rows, subs, STA_CHUNK // rows,
                           plan["n_slots"] * subs,
                           (plan["n_tiles"] * subs, heads, b), stages, smem)


def sta_permuted_walk(plan: StaPermutedPlan, block: int, nbr_row,
                      kb_row) -> List[List[int]]:
    """The permuted kernels' key chunks of one query tile and batch entry,
    as they walk them: the boxes of the slots of `nbr_row` (its row of the
    neighbour table) in slot order, each tile's `plan.subs` boxes in turn,
    a box none of whose keys is unmasked in `kb_row` (that batch entry's kb,
    host numpy) skipped; each box as the kcat row of its first key,
    `plan.boxes` a chunk (a short last chunk loads its first box again,
    masked)."""
    boxes = []
    for nb in nbr_row:
        for sub in range(plan.subs):
            row = int(nb) * block + sub * plan.rows
            if nb >= 0 and (kb_row[row:row + plan.rows] > 0.5 * NEG_INF).any():
                boxes.append(row)
    return [boxes[i:i + plan.boxes] for i in range(0, len(boxes), plan.boxes)]


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def tile_codes(x: torch.Tensor, block: int):
    """Symmetric int8 codes of tile-major x [B, S, H, D] per (batch, tile
    of `block` rows, head), the STA kernels' quant arm: codes as fp32
    [B, S // block, block, H, D] and scales [B, S // block, H] with
    scale = max(max|x|, 1e-6) / 127, codes round(x * (1/scale))."""
    b, s, hh, d = x.shape
    xf = x.float().reshape(b, s // block, block, hh, d)
    m = xf.abs().amax(dim=(2, 4)).clamp_min(1e-6)
    # a true division on every device (on CUDA tensors `m / 127.0` is a
    # product with the rounded reciprocal)
    sc = m / m.new_tensor(127.0)
    return torch.round(xf * (1.0 / sc)[:, :, None, :, None]), sc


def sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window, scale: float,
                       c: Optional[torch.Tensor] = None,
                       qk_int8: bool = False,
                       txt_int8: bool = True) -> torch.Tensor:
    """The function of the permuted kernels, in plain PyTorch.

    qp [B, S_pad, H, D] tile-major image queries; kcat/vcat [B, S_pad +
    txt_pad, H, D] = [image tiles | text padded to whole tiles]; kb
    [B, S_pad + txt_pad] fp32 key bias (-1e30 on padding); c [B, H] static
    offset, or None for the running (exact softmax) arm. qk_int8: int8
    Q.K^T with the tile scales of `tile_codes` (s = s32 * sq*sk*scale);
    txt_int8=False keeps the text blocks' scores in the input type (the
    direct kernel's text fold). Returns [B, S_pad, H*D]; rows of padding
    tokens are zero."""
    b, s_pad, hh, d = qp.shape
    tile = tuple(tile)
    block = tile[0] * tile[1] * tile[2]
    n_tiles = s_pad // block
    plan = tile_plan(tuple(grid), tile, tuple(window), kcat.shape[1] - s_pad)
    dev = qp.device
    nbr = torch.from_numpy(plan["nbr"]).to(dev, torch.long)
    n_slots = nbr.shape[1]
    slot_bias = torch.where(nbr >= 0, 0.0, NEG_INF).to(dev)
    idx = nbr.clamp_min(0)
    row_ok = torch.from_numpy(
        _valid_tokens(grid, plan["padded_grid"]).reshape(-1)[plan["perm"]]
        .reshape(n_tiles, block)).to(dev)
    qt = qp.reshape(b, n_tiles, block, hh, d)
    kt = kcat.reshape(b, -1, block, hh, d)
    vt = vcat.reshape(b, -1, block, hh, d)
    kbt = kb.float().reshape(b, -1, block)
    if qk_int8:
        q8, sq = tile_codes(qp, block)
        k8, sk = tile_codes(kcat, block)
        txt_slot = nbr >= n_tiles                           # [T, S]
    out = torch.empty((b, n_tiles, block, hh * d), dtype=qp.dtype, device=dev)
    for t0 in range(0, n_tiles, PLAIN_TILE_CHUNK):
        t1 = min(t0 + PLAIN_TILE_CHUNK, n_tiles)
        nb = idx[t0:t1]                                     # [C, S]
        cn = t1 - t0
        kg = kt[:, nb].reshape(b, cn, n_slots * block, hh, d)
        vg = vt[:, nb].reshape(b, cn, n_slots * block, hh, d)
        bias = (kbt[:, nb] + slot_bias[t0:t1, :, None]
                ).reshape(b, cn, 1, 1, n_slots * block)
        if qk_int8:
            s32 = torch.einsum("bcqhd,bckhd->bchqk", q8[:, t0:t1],
                               k8[:, nb].reshape(b, cn, n_slots * block, hh,
                                                 d))
            fac = (sq[:, t0:t1, None, :] * sk[:, nb]) * scale  # [B,C,S,H]
            s = (s32.reshape(b, cn, hh, block, n_slots, block)
                 * fac.permute(0, 1, 3, 2)[:, :, :, None, :, None]
                 ).reshape(b, cn, hh, block, n_slots * block)
            if not txt_int8:
                sf = torch.einsum("bcqhd,bckhd->bchqk",
                                  qt[:, t0:t1].float(), kg.float()) * scale
                keep = txt_slot[t0:t1, None, :, None].expand(
                    cn, block, n_slots, block).reshape(
                        cn, block, n_slots * block)
                s = torch.where(keep[None, :, None], sf, s)
        else:
            s = torch.einsum("bcqhd,bckhd->bchqk", qt[:, t0:t1].float(),
                             kg.float()) * scale
        if c is None:
            x = s + bias
            p = torch.exp(x - x.amax(dim=-1, keepdim=True))
        else:
            p = torch.exp(s + (bias - c.float()[:, None, :, None, None]))
        l = p.sum(dim=-1)                                   # [B, C, H, Q]
        o = torch.einsum("bchqk,bckhd->bchqd", p.to(vg.dtype).float(),
                         vg.float()) / l.clamp_min(1e-37)[..., None]
        o = o * row_ok[t0:t1, None, :, None]
        out[:, t0:t1] = o.permute(0, 1, 3, 2, 4).reshape(
            b, cn, block, hh * d).to(qp.dtype)
    return out.reshape(b, s_pad, hh * d)


def sta_tile_codes_plain(x: torch.Tensor, grid, tile):
    """B4q's pre-pass in plain PyTorch: x [B, S_img, H, D] row-major to its
    int8 codes [B, S_img, H*D] (each token with its own tile's scale) and
    the scales [B, H, n_tiles]: `tile_codes` of the tile-major layout, back
    in row-major order."""
    b, s, hh, d = x.shape
    grid, tile = tuple(grid), tuple(tile)
    plan = tile_plan(grid, tile, (1, 1, 1), 0)
    codes, sc = tile_codes(_permute_tokens(x, grid, tile, plan),
                           plan["tokens_per_tile"])
    codes = _unpermute_tokens(codes.reshape(b, -1, hh * d), grid, plan)
    return codes.to(torch.int8), sc.permute(0, 2, 1).contiguous()


def sta_direct_emulate(img_q, img_k, img_v, txt_k, txt_v, txt_bias, c, grid,
                       tile, window, scale: float, img_key_bias=None,
                       quant: bool = False) -> torch.Tensor:
    """B4's (quant: B4q's) walk in plain PyTorch, for checking its plan on
    the CPU: per block, the query box of `sta_box_tokens` with its rows past
    the grid zero (TMA's zero fill), then the key chunks of `sta_walk`,
    each key past the grid zero with bias -1e30 (as is a short chunk's
    repeated box), then the text keys in chunks of `plan.txt_keys`, those
    past Lt zero with bias -1e30; p = exp(s + bias - c) with s = Q.K^T *
    scale, or under quant the image keys' s32 * (sq * sk * scale) from the
    pre-pass's codes, p rounded to V's type before P.V, out = acc /
    max(l, 1e-37), rows past the grid not stored. Arguments as
    `sta_direct`; returns [B, S_img, H*D]."""
    b, s_img, hh, d = img_q.shape
    lt = txt_k.shape[1]
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    plan = plan_sta_direct(b, hh, d, grid, tile, window, lt, quant)
    dev = img_q.device

    def zero_row(x):   # index s_img (or Lt) reads a zero row
        return torch.cat([x, x.new_zeros((b, 1) + x.shape[2:])], dim=1)

    qz, kz, vz = zero_row(img_q), zero_row(img_k), zero_row(img_v)
    if quant:
        q8, sq = sta_tile_codes_plain(img_q, grid, tile)
        k8, sk = sta_tile_codes_plain(img_k, grid, tile)
        q8 = zero_row(q8.float().reshape(b, s_img, hh, d))
        k8 = zero_row(k8.float().reshape(b, s_img, hh, d))
    kb = (img_key_bias.reshape(b, s_img).float() if img_key_bias is not None
          else torch.zeros((b, s_img), device=dev))
    kb = torch.cat([kb, torch.full((b, 1), NEG_INF, device=dev)], dim=1)
    lt_pad = plan.txt_chunks * plan.txt_keys
    tb = (txt_bias.reshape(b, lt).float() if txt_bias is not None
          else torch.zeros((b, lt), device=dev))
    tb = torch.nn.functional.pad(tb, (0, lt_pad - lt), value=NEG_INF)
    tk, tv = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, lt_pad - lt))
              for x in (txt_k, txt_v))
    off = c.float().expand(b, hh)[:, :, None, None]
    out = torch.zeros((b, s_img, hh * d), dtype=img_q.dtype, device=dev)
    n_tiles = plan.blocks[0] // plan.subs
    for qtile in range(n_tiles):
        keys, key_tile, live = [], [], []
        for chunk in sta_walk(grid, tile, window, plan, qtile):
            padded = chunk + [chunk[0]] * (plan.boxes - len(chunk))
            for u, (kt, sub) in enumerate(padded):
                tok = sta_box_tokens(grid, tile, plan, kt, sub)
                keys.append(np.where(tok < 0, s_img, tok))
                key_tile.append(np.full(plan.rows, kt))
                live.append(np.full(plan.rows, u < len(chunk)) & (tok >= 0))
        kidx = torch.from_numpy(np.concatenate(keys)).to(dev)
        kbias = torch.where(torch.from_numpy(np.concatenate(live)).to(dev),
                            kb[:, kidx], NEG_INF)
        for sub in range(plan.subs):
            tok = sta_box_tokens(grid, tile, plan, qtile, sub)
            if tok[0] < 0:
                continue   # no query of the box: the block returns at once
            qidx = torch.from_numpy(np.where(tok < 0, s_img, tok)).to(dev)
            q = qz[:, qidx].float()
            if quant:
                s32 = torch.einsum("bqhd,bkhd->bhqk", q8[:, qidx],
                                   k8[:, kidx])
                fac = sq[:, :, qtile, None] * sk[:, :, torch.from_numpy(
                    np.concatenate(key_tile)).to(dev)]        # [B, H, K]
                s_i = s32 * (fac * scale)[:, :, None, :]
            else:
                s_i = torch.einsum("bqhd,bkhd->bhqk", q,
                                   kz[:, kidx].float()) * scale
            s_t = torch.einsum("bqhd,bkhd->bhqk", q, tk.float()) * scale
            p = torch.exp(torch.cat([s_i + kbias[:, None, None, :],
                                     s_t + tb[:, None, None, :]], -1) - off)
            l = p.sum(-1)
            v = torch.cat([vz[:, kidx], tv], dim=1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                             v.float()) / l.clamp_min(1e-37).transpose(
                                 1, 2)[..., None]
            ok = torch.from_numpy(tok >= 0).to(dev)
            out[:, qidx[ok]] = o[:, ok].reshape(b, -1, hh * d).to(out.dtype)
    return out


def sta_ring_emulate(q5, kp, vp, txt_k, txt_v, txt_bias, c, grid, tile,
                     window, scale: float) -> torch.Tensor:
    """B10's walk in plain PyTorch, for checking its plan on the CPU: per
    block, the query box of `sta_box_tokens` with its rows past the grid
    zero (TMA's zero fill), then the key chunks of `sta_ring_walk`, each box
    R contiguous rows of kp/vp with every key past the grid at bias -1e30
    (the geometry bias; a short chunk's repeated box is masked whole), then
    the text keys in chunks of `plan.txt_keys`, those past Lt zero with
    bias -1e30; p = exp(s*scale + bias - c), p rounded to V's type before
    P.V, out = acc / max(l, 1e-37), rows past the grid not stored.
    Arguments as `sta_ring`; returns [B, T, H, W, H*D]."""
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    b, hd = q5.shape[0], q5.shape[-1]
    hh = c.shape[1]
    d, lt = hd // hh, txt_k.shape[1]
    s_img = grid[0] * grid[1] * grid[2]
    plan = plan_sta_ring(b, hh, d, grid, tile, window, lt)
    dev = q5.device
    q = torch.cat([q5.reshape(b, s_img, hh, d),
                   q5.new_zeros((b, 1, hh, d))], dim=1)   # row s_img: zero
    kr, vr = (x.reshape(b, -1, hh, d) for x in (kp, vp))
    lt_pad = plan.txt_chunks * plan.txt_keys
    tb = torch.nn.functional.pad(txt_bias.reshape(b, lt).float(),
                                 (0, lt_pad - lt), value=NEG_INF)
    tk, tv = (torch.nn.functional.pad(x.reshape(b, lt, hh, d),
                                      (0, 0, 0, 0, 0, lt_pad - lt))
              for x in (txt_k, txt_v))
    off = c.float()[:, :, None, None]
    out = torch.zeros((b, s_img, hd), dtype=q5.dtype, device=dev)
    n_tiles = plan.blocks[0] // plan.subs
    for qtile in range(n_tiles):
        rows, live = [], []
        for chunk in sta_ring_walk(grid, tile, window, plan, qtile):
            padded = chunk + [chunk[0]] * (plan.boxes - len(chunk))
            for u, (kt, sub, row) in enumerate(padded):
                tok = sta_box_tokens(grid, tile, plan, kt, sub)
                rows.append(np.arange(row, row + plan.rows))
                live.append((tok >= 0) & (u < len(chunk)))
        kidx = torch.from_numpy(np.concatenate(rows)).to(dev)
        kbias = torch.where(torch.from_numpy(np.concatenate(live)).to(dev),
                            0.0, NEG_INF)
        keys = torch.cat([kr[:, kidx], tk], dim=1).float()
        vals = torch.cat([vr[:, kidx], tv], dim=1)
        bias = torch.cat([kbias.expand(b, -1), tb], dim=1)
        for sub in range(plan.subs):
            tok = sta_box_tokens(grid, tile, plan, qtile, sub)
            if tok[0] < 0:
                continue   # no query of the box: the block returns at once
            qidx = torch.from_numpy(np.where(tok < 0, s_img, tok)).to(dev)
            s = torch.einsum("bqhd,bkhd->bhqk", q[:, qidx].float(),
                             keys) * scale
            p = torch.exp(s + bias[:, None, None, :] - off)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(vals.dtype).float(),
                             vals.float()) / p.sum(-1).clamp_min(
                                 1e-37).transpose(1, 2)[..., None]
            ok = torch.from_numpy(tok >= 0).to(dev)
            out[:, qidx[ok]] = o[:, ok].reshape(b, -1, hd).to(out.dtype)
    return out.reshape(b, *grid, hd)


def sta_permuted_emulate(qp, kcat, vcat, kb, grid, tile, window,
                         scale: float, c: Optional[torch.Tensor] = None,
                         quant: bool = False) -> torch.Tensor:
    """The permuted kernels' walk in plain PyTorch, for checking their plan
    on the CPU: per block of `plan.rows` query rows of a tile, zeros if none
    of them is a token or no key box is live; else the key chunks of
    `sta_permuted_walk` (its all-masked boxes skipped, a short chunk's
    repeated box at bias -1e30) folded in order. c None (B7): the online
    softmax m' = max(m, max_k(s + kb)), p = exp(s + kb - m'), l and acc
    rescaled by exp(m - m'); c [B, H] (B6a/B6b): p = exp(s + kb - c). s =
    Q.K^T * scale, or under quant (B6q, with c) s32 * (sq * sk * scale) on
    `tile_codes` of qp and kcat, sk that of each key's own tile. p rounded
    to V's type before P.V; out = acc / max(l, 1e-37), padding rows zero.
    Arguments as `sta_permuted_static` (c None: `sta_permuted_running`);
    returns [B, S_pad, H*D]."""
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    b, s_pad, hh, d = qp.shape
    block = tile[0] * tile[1] * tile[2]
    txt_pad = kcat.shape[1] - s_pad
    tplan = tile_plan(grid, tile, window, txt_pad)
    plan = plan_sta_permuted(b, hh, d, grid, tile, window, txt_pad, quant)
    row_ok = torch.from_numpy(
        _valid_tokens(grid, tplan["padded_grid"]).reshape(-1)[tplan["perm"]])
    kbf = kb.float()
    kb_np = kbf.cpu().numpy()
    qs, ks = qp, kcat
    if quant:
        (qs, sq), (ks, sk) = (tile_codes(x, block) for x in (qp, kcat))
        qs, ks = qs.reshape(qp.shape), ks.reshape(kcat.shape)
    out = torch.zeros((b, s_pad, hh * d), dtype=qp.dtype, device=qp.device)
    for qtile in range(tplan["n_tiles"]):
        for sub in range(plan.subs):
            q0 = qtile * block + sub * plan.rows
            ok = row_ok[q0:q0 + plan.rows].to(qp.device)
            if not ok.any():
                continue
            q = qs[:, q0:q0 + plan.rows].float()
            for bi in range(b):
                chunks = sta_permuted_walk(plan, block, tplan["nbr"][qtile],
                                           kb_np[bi])
                m = (torch.full((hh, plan.rows), NEG_INF, device=qp.device)
                     if c is None else
                     c[bi].float()[:, None].expand(hh, plan.rows))
                l = torch.zeros((hh, plan.rows), device=qp.device)
                acc = torch.zeros((hh, plan.rows, d), device=qp.device)
                for chunk in chunks:
                    padded = chunk + [chunk[0]] * (plan.boxes - len(chunk))
                    idx = torch.from_numpy(np.concatenate(
                        [np.arange(r, r + plan.rows) for r in padded])).to(
                            qp.device)
                    bias = kbf[bi, idx].clone()
                    bias[len(chunk) * plan.rows:] = NEG_INF
                    s = torch.einsum("qhd,khd->hqk", q[bi],
                                     ks[bi, idx].float())
                    if quant:   # [H] x [H, K]: each key's own tile
                        s = s * ((sq[bi, qtile][:, None, None]
                                  * sk[bi, idx // block].T[:, None, :])
                                 * scale)
                    else:
                        s = s * scale
                    x = s + bias
                    m_new = m if c is not None else torch.maximum(
                        m, x.amax(-1))
                    p = torch.exp(x - m_new[..., None])
                    corr = torch.exp(m - m_new)
                    l = l * corr + p.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "hqk,khd->hqd", p.to(vcat.dtype).float(),
                        vcat[bi, idx].float())
                    m = m_new
                o = acc / l.clamp_min(1e-37)[..., None] if chunks else acc
                o = o * ok[None, :, None]
                out[bi, q0:q0 + plan.rows] = o.transpose(0, 1).reshape(
                    plan.rows, hh * d).to(out.dtype)
    return out


def permuted_operands(img_q, img_k, img_v, txt_k, txt_v, txt_bias, grid,
                      tile, window, img_key_bias=None):
    """The permuted kernels' inputs from row-major tensors: tile-major qp
    [B, S_pad, H, D], kcat/vcat [B, S_pad + txt_pad, H, D] with the text
    padded to whole tiles, and the key bias kb [B, S_pad + txt_pad] fp32
    (padding tokens -1e30, the permuted `img_key_bias` [B, S_img] if given,
    then the text bias [B, 1, 1, Lt] or zeros). Returns (plan, qp, kcat,
    vcat, kb)."""
    b, s_img, hh, d = img_q.shape
    lt = txt_k.shape[1]
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    block = tile[0] * tile[1] * tile[2]
    txt_pad = _ceil(lt, block) * block
    plan = tile_plan(grid, tile, window, txt_pad)
    qp = _permute_tokens(img_q, grid, tile, plan)
    kp = _permute_tokens(img_k, grid, tile, plan)
    vp = _permute_tokens(img_v, grid, tile, plan)
    pad = (0, 0, 0, 0, 0, txt_pad - lt)
    kcat = torch.cat([kp, torch.nn.functional.pad(txt_k, pad)], dim=1)
    vcat = torch.cat([vp, torch.nn.functional.pad(txt_v, pad)], dim=1)
    dev = img_q.device
    valid = _valid_tokens(grid, plan["padded_grid"]).reshape(-1)[plan["perm"]]
    img_bias = torch.from_numpy(np.where(valid, 0.0, NEG_INF).astype(
        np.float32)).to(dev).expand(b, -1)
    if img_key_bias is not None:
        img_bias = img_bias + _permute_tokens(
            img_key_bias.float()[..., None, None], grid, tile, plan)[..., 0, 0]
    tb = (txt_bias.reshape(b, lt).float() if txt_bias is not None
          else torch.zeros((b, lt), device=dev))
    tb = torch.nn.functional.pad(tb, (0, txt_pad - lt), value=NEG_INF)
    kb = torch.cat([img_bias, tb], dim=1).contiguous()
    return plan, qp, kcat, vcat, kb


def sta_attention_plain(img_q, img_k, img_v, txt_k, txt_v, txt_bias, grid,
                        tile, window, scale: float,
                        c: Optional[torch.Tensor] = None,
                        img_key_bias: Optional[torch.Tensor] = None,
                        qk_int8: bool = False) -> torch.Tensor:
    """Plain version of all STA kernels: the forward of the JAX package's
    `sta_gathered_attention` for the image queries. img_q/k/v
    [B, S_img, H, D] row-major over `grid`; txt_k/v [B, Lt, H, D]; txt_bias
    [B, 1, 1, Lt] (or [B, Lt]) fp32 or None; c [B, H] static offset, or
    None for the running arm; img_key_bias optional [B, S_img] fp32 added
    to the image keys; qk_int8: the direct kernel's int8 arm (image Q.K^T
    in int8, the text keys in the input type). Query tiles are processed
    PLAIN_TILE_CHUNK at a time. Returns [B, S_img, H*D]."""
    plan, qp, kcat, vcat, kb = permuted_operands(
        img_q, img_k, img_v, txt_k, txt_v, txt_bias, grid, tile, window,
        img_key_bias)
    out = sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window, scale,
                             c, qk_int8, txt_int8=False)
    return _unpermute_tokens(out, tuple(grid), plan)


def sta_ring_plain(q5, kp, vp, txt_k, txt_v, txt_bias, c, grid, tile,
                   window, scale: float) -> torch.Tensor:
    """The ring kernel's function from its own operands, in plain PyTorch:
    q5 [B, T, H, W, H*D] row-major queries; kp/vp [B, S_pad, H*D] w-major
    (`_permute_tokens_cols`); txt_k/txt_v [B, Lt, H*D]; txt_bias [B, Lt]
    fp32; c [B, heads] static offsets. Each query tile gathers its window
    columns as wt runs of wh tiles (`ring_plan`), masked as the kernel masks
    them, then the text keys; p = exp(s*scale + (bias - c)), rounded to V's
    type before P.V, out = acc / max(l, 1e-37). PLAIN_TILE_CHUNK query
    tiles at a time. Returns [B, T, H, W, H*D]."""
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    if not ring_geometry_ok(grid, tile, window):
        raise ValueError(f"sta_ring: grid {grid} with tile {tile} has fewer "
                         f"h-tiles than window {window} needs, or ww < 2")
    b, hd = q5.shape[0], q5.shape[-1]
    hh = c.shape[1]
    d = hd // hh
    lt = txt_k.shape[1]
    # the token layout only: tile_plan's neighbour table takes odd windows
    plan = tile_plan(grid, tile, (1, 1, 1), 0)
    n_tiles, block = plan["n_tiles"], plan["tokens_per_tile"]
    rows, kbias = (torch.from_numpy(x).to(q5.device)
                   for x in ring_plan(grid, tile, window))
    n_keys = rows.shape[1]
    qt = _permute_tokens(q5.reshape(b, -1, hh, d), grid, tile, plan).reshape(
        b, n_tiles, block, hh, d)
    tk = txt_k.reshape(b, lt, hh, d).float()
    tv = txt_v.reshape(b, lt, hh, d).float()
    tb = txt_bias.float()[:, None, None, None, :]
    off = c.float()[:, None, :, None, None]
    out = torch.empty((b, n_tiles, block, hd), dtype=q5.dtype,
                      device=q5.device)
    for t0 in range(0, n_tiles, PLAIN_TILE_CHUNK):
        t1 = min(t0 + PLAIN_TILE_CHUNK, n_tiles)
        cn = t1 - t0
        kg = kp[:, rows[t0:t1]].reshape(b, cn, n_keys, hh, d).float()
        vg = vp[:, rows[t0:t1]].reshape(b, cn, n_keys, hh, d).float()
        q = qt[:, t0:t1].float()
        s = torch.cat([
            torch.einsum("bcqhd,bckhd->bchqk", q, kg) * scale
            + kbias[None, t0:t1, None, None, :],
            torch.einsum("bcqhd,blhd->bchql", q, tk) * scale + tb], dim=-1)
        p = torch.exp(s - off)
        l = p.sum(dim=-1)
        p = p.to(vp.dtype).float()
        o = (torch.einsum("bchqk,bckhd->bchqd", p[..., :n_keys], vg)
             + torch.einsum("bchql,blhd->bchqd", p[..., n_keys:], tv))
        o = o / l.clamp_min(1e-37)[..., None]
        out[:, t0:t1] = o.permute(0, 1, 3, 2, 4).reshape(
            b, cn, block, hd).to(q5.dtype)
    return _unpermute_tokens(out.reshape(b, -1, hd), grid, plan).reshape(
        b, *grid, hd)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _device_nbr(grid, tile, window, txt_pad, device) -> torch.Tensor:
    """The neighbour table on the card, uploaded once per plan."""
    nbr = tile_plan(grid, tile, window, txt_pad)["nbr"]
    return torch.from_numpy(np.ascontiguousarray(nbr)).to(device)


def _check(name, tensors, dtype):
    for what, x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {what} is on {x.device}, not a CUDA "
                             f"device")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {what} is {x.dtype}, q is {dtype}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} takes bf16 or fp16, got {dtype}")


def _ptr(x):
    """A tensor's address for a C argument, or None (a null pointer)."""
    return x.data_ptr() if x is not None else None


def _rows_for_tma(name, **views):
    """Each [B, S, H, D] view as TMA reads it (`_as_rows`: a copy only if
    its heads are not packed in 16-byte aligned rows), checked by
    `tma_view_error`."""
    out = []
    for what, x in views.items():
        x = _as_rows(x)
        err = tma_view_error(what, x.shape, x.stride(), x.data_ptr(),
                             x.element_size())
        if err:
            raise ValueError(f"{name}: {err}")
        out.append(x)
    return out


def sta_tile_codes(img_q, img_k, grid, tile):
    """B4q's pre-pass (csrc/sta_direct.cu:tile_codes_kernel): the int8
    codes of img_q and img_k [B, S_img, H, D] in the row-major grid, each
    token with its own tile's scale, and the scales: (q8, k8 [B, S_img,
    H*D] int8, sq, sk [B, H, n_tiles] fp32). Kernel on CUDA tensors,
    `sta_tile_codes_plain` on CPU tensors."""
    grid, tile = tuple(grid), tuple(tile)
    if img_q.device.type == "cpu":
        (q8, sq), (k8, sk) = (sta_tile_codes_plain(x, grid, tile)
                              for x in (img_q, img_k))
        return q8, k8, sq, sk
    name = "sta_tile_codes"
    _check(name, (("img_q", img_q), ("img_k", img_k)), img_q.dtype)
    b, s_img, hh, d = img_q.shape
    if img_k.shape != img_q.shape or s_img != grid[0] * grid[1] * grid[2]:
        raise ValueError(f"{name}: bad shapes q {tuple(img_q.shape)} k "
                         f"{tuple(img_k.shape)} for grid {grid}")
    q, k = _rows_for_tma(name, img_q=img_q, img_k=img_k)
    n_tiles = int(np.prod([_ceil(n, t) for n, t in zip(grid, tile)]))
    q8, k8 = (torch.empty((b, s_img, hh * d), dtype=torch.int8,
                          device=q.device) for _ in range(2))
    sq, sk = (torch.empty((b, hh, n_tiles), dtype=torch.float32,
                          device=q.device) for _ in range(2))
    err = cuda_lib.library("sta_direct").hv_sta_tile_codes(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1), b, hh, *grid, *tile,
        q8.data_ptr(), k8.data_ptr(), sq.data_ptr(), sk.data_ptr(),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, name)
    return q8, k8, sq, sk


def _direct(name, quant, img_q, img_k, img_v, txt_k, txt_v, txt_bias, c,
            grid, tile, window, scale, img_key_bias):
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    if img_q.device.type == "cpu":
        return sta_attention_plain(img_q, img_k, img_v, txt_k, txt_v,
                                   txt_bias, grid, tile, window, scale, c,
                                   img_key_bias, qk_int8=quant)
    _check(name, (("img_q", img_q), ("img_k", img_k), ("img_v", img_v),
                  ("txt_k", txt_k), ("txt_v", txt_v)), img_q.dtype)
    b, s_img, hh, d = img_q.shape
    lt = txt_k.shape[1]
    err = sta_direct_gate(tile, window, d)
    if err:
        raise ValueError(f"{name}: {err}")
    if s_img != grid[0] * grid[1] * grid[2] or img_k.shape != img_q.shape \
            or img_v.shape != img_q.shape \
            or txt_k.shape != (b, lt, hh, d) or txt_v.shape != txt_k.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(img_q.shape)} "
                         f"for grid {grid}, txt {tuple(txt_k.shape)}")
    q, k, v, tk, tv = _rows_for_tma(name, img_q=img_q, img_k=img_k,
                                    img_v=img_v, txt_k=txt_k, txt_v=txt_v)
    kb = (img_key_bias.reshape(b, s_img).float().contiguous()
          if img_key_bias is not None else None)
    tb = (txt_bias.reshape(b, lt).float().contiguous()
          if txt_bias is not None else None)
    cc = c.float().expand(b, hh).contiguous()
    q8 = k8 = sq = sk = None
    if quant:
        q8, k8, sq, sk = sta_tile_codes(q, k, grid, tile)
    out = torch.empty((b, s_img, hh * d), dtype=q.dtype, device=q.device)
    err = cuda_lib.library("sta_direct").hv_sta_direct_fwd(
        _DTYPE_CODE[q.dtype], int(quant), d, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), tk.data_ptr(), tv.data_ptr(), _ptr(kb),
        _ptr(tb), cc.data_ptr(), _ptr(q8), _ptr(k8), _ptr(sq), _ptr(sk), b, hh,
        lt, *grid, *tile, *window, q.stride(0), q.stride(1), k.stride(0),
        k.stride(1), v.stride(0), v.stride(1), tk.stride(0), tk.stride(1),
        tv.stride(0), tv.stride(1), out.stride(0), out.stride(1),
        float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, name)
    return out


def sta_direct(img_q, img_k, img_v, txt_k, txt_v, txt_bias, c, grid, tile,
               window, scale: float, img_key_bias=None) -> torch.Tensor:
    """B4 (csrc/sta_direct.cu): static-offset STA in the row-major token
    grid. img_q/k/v [B, S_img, H, D]; txt_k/v [B, Lt, H, D]; txt_bias
    [B, 1, 1, Lt] (or [B, Lt]) fp32 or None; c [B, H] fp32 offsets;
    img_key_bias optional [B, S_img] fp32. Returns [B, S_img, H*D]. Kernel
    on CUDA tensors (inside `sta_direct_gate`; it raises outside), plain
    version on CPU tensors."""
    with span("sta_direct"):
        out = _direct("sta_direct", False, img_q, img_k, img_v, txt_k, txt_v,
                      txt_bias, c, grid, tile, window, scale, img_key_bias)
    if img_q.device.type != "cpu":
        sta_direct.LAUNCHES += 1
    return out


sta_direct.LAUNCHES = 0


def sta_direct_int8(img_q, img_k, img_v, txt_k, txt_v, txt_bias, c, grid,
                    tile, window, scale: float,
                    img_key_bias=None) -> torch.Tensor:
    """B4q (csrc/sta_direct.cu, QUANT): as `sta_direct` with the image
    Q.K^T in int8 (the tile scales of `sta_tile_codes`, its pre-pass) and
    the text keys in the input type; c must bound the int8 scores
    (inflated). Kernel on CUDA tensors, plain version on CPU."""
    with span("sta_direct_int8"):
        out = _direct("sta_direct_int8", True, img_q, img_k, img_v, txt_k,
                      txt_v, txt_bias, c, grid, tile, window, scale,
                      img_key_bias)
    if img_q.device.type != "cpu":
        sta_direct_int8.LAUNCHES += 1
    return out


sta_direct_int8.LAUNCHES = 0


def sta_permuted_codes(qp, kcat, tile):
    """B6q's pre-pass (csrc/sta_permuted.cu:tile_codes_kernel): the int8
    codes of tile-major qp [B, S_pad, H, D] and kcat [B, n_ktiles*block, H,
    D], one scale per (batch, head, tile of `block` rows), padding rows
    included: (q8 [B, S_pad, H*D], k8 [B, n_ktiles*block, H*D] int8, sq
    [B, H, n_tiles], sk [B, H, n_ktiles] fp32), `tile_codes` in the kernel's
    layout. Kernel on CUDA tensors, `tile_codes` on CPU tensors."""
    block = tile[0] * tile[1] * tile[2]
    b, s_pad, hh, d = qp.shape
    if qp.device.type == "cpu":
        (q8, sq), (k8, sk) = (tile_codes(x, block) for x in (qp, kcat))
        return (q8.to(torch.int8).reshape(b, s_pad, hh * d),
                k8.to(torch.int8).reshape(b, -1, hh * d),
                sq.permute(0, 2, 1).contiguous(),
                sk.permute(0, 2, 1).contiguous())
    name = "sta_permuted_codes"
    _check(name, (("qp", qp), ("kcat", kcat)), qp.dtype)
    if d not in (64, 128) or block % 64 or s_pad % block \
            or kcat.shape[1] % block or kcat.shape[0::2] != (b, hh) \
            or kcat.shape[-1] != d:
        raise ValueError(f"{name}: bad shapes qp {tuple(qp.shape)} kcat "
                         f"{tuple(kcat.shape)} for tile {tuple(tile)}")
    q, k = _rows_for_tma(name, qp=qp, kcat=kcat)
    n_tiles, n_ktiles = s_pad // block, k.shape[1] // block
    q8 = torch.empty((b, s_pad, hh * d), dtype=torch.int8, device=q.device)
    k8 = torch.empty((b, k.shape[1], hh * d), dtype=torch.int8,
                     device=q.device)
    sq = torch.empty((b, hh, n_tiles), dtype=torch.float32, device=q.device)
    sk = torch.empty((b, hh, n_ktiles), dtype=torch.float32, device=q.device)
    err = cuda_lib.library("sta_permuted").hv_sta_permuted_codes(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), q.stride(0), q.stride(1),
        k.data_ptr(), k.stride(0), k.stride(1), b, hh, n_tiles, n_ktiles,
        block, q8.data_ptr(), k8.data_ptr(), sq.data_ptr(), sk.data_ptr(),
        cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, name)
    return q8, k8, sq, sk


def _permuted(name, running, qp, kcat, vcat, kb, c, grid, tile, window,
              scale, quant=False):
    """B7 (running), B6a/B6b or B6q (quant) of csrc/sta_permuted.cu on
    tile-major qp and kcat/vcat [B, S, H, D], checked by the gate of
    `plan_sta_permuted`; the plain version on CPU tensors."""
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    if qp.device.type == "cpu":
        return sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                  scale, c, qk_int8=quant)
    _check(name, (("qp", qp), ("kcat", kcat), ("vcat", vcat)), qp.dtype)
    b, s_pad, hh, d = qp.shape
    txt_pad = kcat.shape[1] - s_pad
    plan_sta_permuted(b, hh, d, grid, tile, window, txt_pad, quant, name)
    block = tile[0] * tile[1] * tile[2]
    tplan = tile_plan(grid, tile, window, txt_pad)
    if s_pad != tplan["n_tiles"] * block or vcat.shape != kcat.shape \
            or kcat.shape[0::2] != (b, hh) or kcat.shape[-1] != d \
            or txt_pad % block or kb.shape != (b, kcat.shape[1]):
        raise ValueError(f"{name}: bad shapes qp {tuple(qp.shape)} kcat "
                         f"{tuple(kcat.shape)} kb {tuple(kb.shape)} for "
                         f"grid {grid}, tile {tile}")
    q, k, v = _rows_for_tma(name, qp=qp, kcat=kcat, vcat=vcat)
    kbf = kb.float().contiguous()
    cc = None if running else c.float().expand(b, hh).contiguous()
    nbr = _device_nbr(grid, tile, window, txt_pad, q.device)
    sq = sk = None
    if quant:   # the kernel reads the codes in place of q and k
        q, k, sq, sk = sta_permuted_codes(q, k, tile)
    out = torch.empty((b, s_pad, hh * d), dtype=v.dtype, device=v.device)
    err = cuda_lib.library("sta_permuted").hv_sta_permuted_fwd(
        _DTYPE_CODE[v.dtype], int(running), int(quant), d, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), kbf.data_ptr(), _ptr(cc),
        nbr.data_ptr(), _ptr(sq), _ptr(sk), b, hh, nbr.shape[1],
        k.shape[1] // block, *grid, *tile, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), v.stride(0), v.stride(1), out.stride(0),
        out.stride(1), kbf.stride(0), float(scale),
        cuda_lib.stream_ptr(v.device))
    cuda_lib.check(err, name)
    return out


def sta_permuted_static(qp, kcat, vcat, kb, c, grid, tile, window,
                        scale: float) -> torch.Tensor:
    """B6a/B6b (csrc/sta_permuted.cu, RUNNING=0): static-offset STA on
    the tile-major layout of `permuted_operands`; c [B, H] fp32. Returns
    [B, S_pad, H*D] tile-major, padding rows zero. Kernel on CUDA tensors
    (inside `sta_permuted_gate`; it raises outside), plain version on
    CPU."""
    with span("sta_permuted_static"):
        out = _permuted("sta_permuted_static", False, qp, kcat, vcat, kb, c,
                        grid, tile, window, scale)
    if qp.device.type != "cpu":
        sta_permuted_static.LAUNCHES += 1
    return out


sta_permuted_static.LAUNCHES = 0


def sta_permuted_static_int8(qp, kcat, vcat, kb, c, grid, tile, window,
                             scale: float) -> torch.Tensor:
    """B6q (csrc/sta_permuted.cu, QUANT=1): as `sta_permuted_static` with
    Q.K^T in int8, every key tile of kcat (text blocks included) quantized
    with its own scale by the pre-pass `sta_permuted_codes`; c must bound
    the int8 scores (inflated). Kernel on CUDA tensors (inside
    `sta_permuted_gate`; it raises outside), plain version on CPU."""
    with span("sta_permuted_static_int8"):
        out = _permuted("sta_permuted_static_int8", False, qp, kcat, vcat, kb,
                        c, grid, tile, window, scale, quant=True)
    if qp.device.type != "cpu":
        sta_permuted_static_int8.LAUNCHES += 1
    return out


sta_permuted_static_int8.LAUNCHES = 0


def sta_permuted_running(qp, kcat, vcat, kb, grid, tile, window,
                         scale: float) -> torch.Tensor:
    """B7 (csrc/sta_permuted.cu, RUNNING=1): running-max STA on the
    tile-major layout of `permuted_operands`. Returns [B, S_pad, H*D]
    tile-major, padding rows zero. Kernel on CUDA tensors (inside
    `sta_permuted_gate`; it raises outside), plain version on CPU."""
    with span("sta_permuted_running"):
        out = _permuted("sta_permuted_running", True, qp, kcat, vcat, kb, None,
                        grid, tile, window, scale)
    if qp.device.type != "cpu":
        sta_permuted_running.LAUNCHES += 1
    return out


sta_permuted_running.LAUNCHES = 0


def sta_ring(q5, kp, vp, txt_k, txt_v, txt_bias, c, grid, tile, window,
             scale: float) -> torch.Tensor:
    """B10 (csrc/sta_direct.cu, RING): static-offset STA reading K/V as
    contiguous window-column runs of the w-major layout, validity computed
    in the kernel from the geometry (no neighbour table, no key-bias
    operand). q5 [B, T, H, W, H*D] row-major; kp/vp [B, S_pad, H*D] from
    `_permute_tokens_cols`; txt_k/txt_v [B, Lt, H*D]; txt_bias [B, Lt]
    fp32; c [B, heads] fp32 (heads = c.shape[1]). Returns [B, T, H, W,
    H*D]. Kernel on CUDA tensors (inside `sta_ring_gate`; it raises
    outside), `sta_ring_plain` on CPU tensors."""
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    with span("sta_ring"):
        if q5.device.type == "cpu":
            return sta_ring_plain(q5, kp, vp, txt_k, txt_v, txt_bias, c,
                                  grid, tile, window, scale)
        out = _ring_launch(q5, kp, vp, txt_k, txt_v, txt_bias, c, grid, tile,
                           window, scale)
    sta_ring.LAUNCHES += 1
    return out


def _ring_launch(q5, kp, vp, txt_k, txt_v, txt_bias, c, grid, tile, window,
                 scale):
    name = "sta_ring"
    _check(name, (("q5", q5), ("kp", kp), ("vp", vp), ("txt_k", txt_k),
                  ("txt_v", txt_v)), q5.dtype)
    b, hd = q5.shape[0], q5.shape[-1]
    hh = c.shape[1]
    d = hd // hh
    lt = txt_k.shape[1]
    plan_sta_ring(b, hh, d, grid, tile, window, lt)   # raises outside it
    s_pad = int(np.prod(_padded_grid(grid, tile)))
    if q5.shape != (b, *grid, hh * d) or kp.shape != (b, s_pad, hd) \
            or vp.shape != kp.shape or txt_k.shape != (b, lt, hd) \
            or txt_v.shape != txt_k.shape or txt_bias.shape != (b, lt) \
            or c.shape != (b, hh):
        raise ValueError(f"{name}: bad shapes q5 {tuple(q5.shape)} kp "
                         f"{tuple(kp.shape)} txt {tuple(txt_k.shape)} "
                         f"bias {tuple(txt_bias.shape)} c {tuple(c.shape)} "
                         f"for grid {grid}, tile {tile}")
    n_img = grid[0] * grid[1] * grid[2]
    q, k, v, tk, tv = _rows_for_tma(
        name, q5=q5.reshape(b, n_img, hh, d), kp=kp.reshape(b, s_pad, hh, d),
        vp=vp.reshape(b, s_pad, hh, d), txt_k=txt_k.reshape(b, lt, hh, d),
        txt_v=txt_v.reshape(b, lt, hh, d))
    tb = txt_bias.float().contiguous()
    cc = c.float().contiguous()
    out = torch.empty((b, *grid, hd), dtype=q5.dtype, device=q5.device)
    err = cuda_lib.library("sta_direct").hv_sta_ring_fwd(
        _DTYPE_CODE[q5.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), tk.data_ptr(), tv.data_ptr(), tb.data_ptr(),
        cc.data_ptr(), b, hh, lt, *grid, *tile, *window,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), tk.stride(0), tk.stride(1), tv.stride(0), tv.stride(1),
        out.stride(0), out.stride(3), float(scale),
        cuda_lib.stream_ptr(q5.device))
    cuda_lib.check(err, name)
    return out


sta_ring.LAUNCHES = 0


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def txt_merge_attention(txt_q, kp, vp, img_bias, txt_k, txt_v, txt_bias,
                        c, scale):
    """Text queries over [img | txt] as the merge of two partial-softmax
    flash states with a shared static offset `c` (exact). kp/vp hold the
    image keys in any token order ([B, S, H*D] or [B, S, H, D]); img_bias
    [B, S] fp32 masks their padding in the same order, or None."""
    b, _, hh, d = txt_q.shape
    s = kp.shape[1]
    s1 = flash_attention(
        txt_q, kp.reshape(b, s, hh, d), vp.reshape(b, s, hh, d),
        key_bias=img_bias, scale=scale, bound_mode="static", score_bound=c,
        return_state=True)
    s2 = flash_attention(
        txt_q, txt_k, txt_v, key_bias=txt_bias, scale=scale,
        bound_mode="static", score_bound=c, return_state=True)
    txt_out, _, _ = merge_flash_states(s1, s2)
    return txt_out


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported to the PyTorch package "
                              f"yet")


_STA_RING = False


def set_sta_ring(on: bool) -> None:
    """Default for sta_joint_attention(ring=None), so the DiT needs no
    plumbing: route the static direct arm through the ring kernel
    (`sta_ring`, B10) when the geometry admits it. Read at every call."""
    global _STA_RING
    _STA_RING = bool(on)


def _ring_image(img_q, img_k, img_v, txt_k, txt_v, txt_bias, c, grid, tile,
                window, scale):
    """The image queries through `sta_ring`: the w-major K/V copies, the
    row-major queries as a 5-d view, the text flattened to [B, Lt, H*D]."""
    b, s_img, hh, d = img_q.shape
    lt = txt_k.shape[1]
    pg = _padded_grid(grid, tile)
    kp = _permute_tokens_cols(img_k, grid, tile, pg)
    vp = _permute_tokens_cols(img_v, grid, tile, pg)
    tb = (txt_bias.reshape(b, lt).float() if txt_bias is not None
          else torch.zeros((b, lt), device=img_q.device))
    out5 = sta_ring(img_q.reshape(b, *grid, hh * d), kp, vp,
                    txt_k.reshape(b, lt, hh * d), txt_v.reshape(b, lt, hh * d),
                    tb, c, grid, tile, window, scale)
    return out5.reshape(b, s_img, hh * d)


def sta_joint_attention(
    img_q: torch.Tensor,  # [B, S_img, H, D] row-major (t, h, w) tokens
    img_k: torch.Tensor,
    img_v: torch.Tensor,
    txt_q: torch.Tensor,  # [B, Lt, H, D]
    txt_k: torch.Tensor,
    txt_v: torch.Tensor,
    txt_bias: Optional[torch.Tensor],  # [B, 1, 1, Lt]
    grid: Tuple[int, int, int],
    tile: Tuple[int, int, int] = (4, 8, 8),
    window: Tuple[int, int, int] = (3, 3, 3),
    scale: Optional[float] = None,
    bound_mode: str = "auto",
    qk_int8: bool = False,
    slot_block: Optional[int] = None,
    head_block: Optional[int] = None,
    fused: bool = True,
    score_bound: Optional[torch.Tensor] = None,
    direct: bool = True,
    lane_rotate: Optional[bool] = None,
    ring: Optional[bool] = None,
    img_key_bias: Optional[torch.Tensor] = None,
    plain: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STA for the image queries + full attention for the text queries;
    returns (img_out [B, S_img, H*D], txt_out [B, Lt, H*D]).

    bound_mode "static" (valid under QK-norm) with direct and fused takes
    `sta_direct`, and the text queries `txt_merge_attention` (two static
    flash calls with state, merged). "static" with direct=False or
    fused=False takes `sta_permuted_static` on the tile-major [img | txt]
    keys, and the text queries one static flash call over the same keys.
    Any other bound_mode takes `sta_permuted_running`, the text queries
    `flash_attention(bound_mode="auto")` over those keys.

    qk_int8 (needs bound_mode "static"): the image queries take the int8
    arms `sta_direct_int8` / `sta_permuted_static_int8`, and the static
    bound is inflated by `int8_bound_inflation` for the image and the text
    queries alike (the text queries stay bf16 flash).

    ring (None: the module default, `set_sta_ring`): the static direct arm
    takes `sta_ring` (B10) instead of `sta_direct` when JAX's gate admits
    the call (sta.py:1454-1463): no qk_int8, no slot_block, no
    img_key_bias, at least wh tile rows and a window at least 2 columns
    wide; otherwise it takes `sta_direct`, as JAX does. The text queries of
    the ring arm read the unpadded image keys (`txt_merge_attention`, as
    the direct arm; JAX's card branch merges over the w-major copies, the
    same function since full attention does not depend on key order).

    score_bound: bound on |q.k|*scale broadcastable to [B, H]; without one
    the Cauchy-Schwarz bound of the image-query and all-key row norms.
    img_key_bias: optional additive fp32 [B, S_img] on the image keys, for
    image and text queries alike. plain=True routes the image queries to
    `sta_attention_plain` (a reference for checks on the card).
    slot_block, head_block: accepted for signature parity with the JAX
    function; the CUDA kernels fix their own tiles (B4, B4q, B10, B7, B6a/b
    and B6q: boxes of up to 128 query rows, key chunks of 128).
    lane_rotate (a TPU DMA-elision plan) is not ported.
    """
    del head_block
    if qk_int8 and bound_mode != "static":
        raise ValueError("sta qk_int8 requires bound_mode='static' "
                         "(QK-norm score bound)")
    if lane_rotate not in (None, False):
        _not_ported(f"STA lane rotation (lane_rotate={lane_rotate!r})")
    b, s_img, hh, d = img_q.shape
    lt = txt_q.shape[1]
    scale = scale if scale is not None else d ** -0.5
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    if s_img != grid[0] * grid[1] * grid[2]:
        raise ValueError(f"{s_img} image tokens for grid {grid}")

    def static_bound():
        infl = int8_bound_inflation(d) if qk_int8 else 1.0
        if score_bound is not None:
            return torch.as_tensor(score_bound, dtype=torch.float32,
                                   device=img_q.device).expand(b, hh) * infl
        qn = img_q.float().square().sum(-1).sqrt().amax(dim=1)
        kn = torch.maximum(img_k.float().square().sum(-1).sqrt().amax(dim=1),
                           txt_k.float().square().sum(-1).sqrt().amax(dim=1))
        return qn * kn * scale * infl

    if bound_mode == "static" and direct and fused:
        c = static_bound()
        use_ring = ((_STA_RING if ring is None else ring) and not qk_int8
                    and slot_block is None and img_key_bias is None
                    and ring_geometry_ok(grid, tile, window))
        if plain:
            img_out = sta_attention_plain(img_q, img_k, img_v, txt_k, txt_v,
                                          txt_bias, grid, tile, window, scale,
                                          c, img_key_bias, qk_int8=qk_int8)
        elif use_ring:
            img_out = _ring_image(img_q, img_k, img_v, txt_k, txt_v,
                                  txt_bias, c, grid, tile, window, scale)
        else:
            fn = sta_direct_int8 if qk_int8 else sta_direct
            img_out = fn(img_q, img_k, img_v, txt_k, txt_v, txt_bias, c, grid,
                         tile, window, scale, img_key_bias)
        # the image half reads the unpadded keys: full attention does not
        # depend on key order, and the kernels mask ragged edges themselves
        txt_out = txt_merge_attention(
            txt_q, img_k, img_v,
            img_key_bias.float() if img_key_bias is not None else None,
            txt_k, txt_v, txt_bias, c, scale)
        return img_out, txt_out

    plan, qp, kcat, vcat, kb = permuted_operands(
        img_q, img_k, img_v, txt_k, txt_v, txt_bias, grid, tile, window,
        img_key_bias)
    static = bound_mode == "static"
    c = static_bound() if static else None
    if plain:
        out_p = sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                   scale, c, qk_int8=qk_int8)
    elif static:
        fn = sta_permuted_static_int8 if qk_int8 else sta_permuted_static
        out_p = fn(qp, kcat, vcat, kb, c, grid, tile, window, scale)
    else:
        out_p = sta_permuted_running(qp, kcat, vcat, kb, grid, tile, window,
                                     scale)
    img_out = _unpermute_tokens(out_p, grid, plan)
    txt_out = flash_attention(
        txt_q, kcat, vcat, key_bias=kb, scale=scale,
        bound_mode="static" if static else "auto", score_bound=c)
    return img_out, txt_out


# --------------------------------------------------------------------------
# trainable STA: differentiable gathered form + kernel-forward wrapper
# --------------------------------------------------------------------------

def sta_gathered_attention(img_q, img_k, img_v, txt_q, txt_k, txt_v, txt_bias,
                           *, grid, tile=(4, 8, 8), window=(3, 3, 3),
                           scale=None, tile_chunk: int = 32,
                           img_key_bias=None):
    """Differentiable plain-PyTorch STA with the tile plan of the kernels
    (JAX `sta_gathered_attention`): per query tile the neighbour key/value
    tiles are gathered into one key set, the text keys appended, and an
    fp32 softmax runs per tile, so autograd derives the sparse backward (the
    gather's transpose scatter-adds dK/dV). `tile_chunk` query tiles are
    processed per step. img_key_bias, optional fp32 [B, S_img], is added to
    the image keys for every query, as the kernels add it (the ring x STA
    halo's wrap mask). Returns (img_out [B, S_img, H*D], txt_out
    [B, Lt, H*D]); the text queries keep full attention over [img | txt]."""
    from .attention import chunked_attention, sdpa_attention

    b, s_img, hh, d = img_q.shape
    lt = txt_q.shape[1]
    scale = scale if scale is not None else d ** -0.5
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    block = tile[0] * tile[1] * tile[2]
    plan = tile_plan(grid, tile, window, 0)
    n_tiles, n_slots = plan["n_tiles"], plan["n_slots"]
    dev = img_q.device
    nbr = torch.from_numpy(plan["nbr"]).to(dev, torch.long)

    def tiles(x):
        return _permute_tokens(x, grid, tile, plan).reshape(
            b, n_tiles, block, hh, d)

    qt, kt, vt = tiles(img_q), tiles(img_k), tiles(img_v)
    # zero-padded tokens of edge tiles must not be attended as keys; -1
    # slots gather tile 0 and are masked
    valid = _valid_tokens(grid, plan["padded_grid"]).reshape(-1)[plan["perm"]]
    tok_bias = torch.from_numpy(np.where(valid, 0.0, NEG_INF).astype(
        np.float32)).to(dev).reshape(n_tiles, block)
    ikb = (None if img_key_bias is None else _permute_tokens(
        img_key_bias.reshape(b, s_img).float()[..., None, None], grid, tile,
        plan).reshape(b, n_tiles, block))
    slot_bias = torch.where(nbr >= 0, 0.0, NEG_INF).to(dev)
    idx = nbr.clamp_min(0)
    tb_row = (txt_bias.reshape(b, lt).float() if txt_bias is not None
              else torch.zeros((b, lt), device=dev))

    outs = []
    for t0 in range(0, n_tiles, tile_chunk):
        t1 = min(t0 + tile_chunk, n_tiles)
        nb, cn = idx[t0:t1], t1 - t0
        q_c = qt[:, t0:t1].float()
        kg = kt[:, nb].reshape(b, cn, n_slots * block, hh, d)
        vg = vt[:, nb].reshape(b, cn, n_slots * block, hh, d)
        kb = (tok_bias[nb] + slot_bias[t0:t1, :, None]).reshape(
            cn, n_slots * block)
        s_i = torch.einsum("bcqhd,bckhd->bchqk", q_c, kg.float()) * scale
        s_i = s_i + kb[None, :, None, None, :]
        if ikb is not None:
            s_i = s_i + ikb[:, nb].reshape(b, cn, 1, 1, n_slots * block)
        s_t = torch.einsum("bcqhd,blhd->bchql", q_c, txt_k.float()) * scale
        s_t = s_t + tb_row[:, None, None, None, :]
        p = torch.softmax(torch.cat([s_i, s_t], dim=-1), dim=-1)
        o = (torch.einsum("bchqk,bckhd->bcqhd",
                          p[..., :n_slots * block].to(vg.dtype), vg)
             + torch.einsum("bchql,blhd->bcqhd",
                            p[..., n_slots * block:].to(txt_v.dtype), txt_v))
        outs.append(o.reshape(b, cn, block, hh * d).to(img_q.dtype))
    out_t = torch.cat(outs, dim=1).reshape(b, n_tiles * block, hh * d)
    img_out = _unpermute_tokens(out_t, grid, plan, tile)

    ib_row = (img_key_bias.reshape(b, s_img).float()
              if img_key_bias is not None
              else torch.zeros((b, s_img), device=dev))
    full_kb = torch.cat([ib_row, tb_row], dim=1)[:, None, None, :]
    k_all = torch.cat([img_k, txt_k], dim=1)
    v_all = torch.cat([img_v, txt_v], dim=1)
    if s_img > 8192:
        txt_out = chunked_attention(txt_q, k_all, v_all, key_bias=full_kb,
                                    scale=scale)
    else:
        txt_out = sdpa_attention(txt_q, k_all, v_all, bias=full_kb,
                                 scale=scale)
    return img_out, txt_out


class _STATrainable(torch.autograd.Function):
    """Kernel forward (`sta_joint_attention`), gathered-form backward: both
    compute the same function, so autograd through `sta_gathered_attention`
    on the saved inputs gives the sparse attention gradients. txt_bias,
    img_key_bias and score_bound (which only shifts the kernels' exponent
    offset) get no gradient."""

    @staticmethod
    def forward(ctx, iq, ik, iv, tq, tk, tv, txt_bias, img_key_bias,
                score_bound, opts):
        ctx.save_for_backward(iq, ik, iv, tq, tk, tv, txt_bias, img_key_bias)
        ctx.opts = opts
        return sta_joint_attention(iq, ik, iv, tq, tk, tv, txt_bias,
                                   score_bound=score_bound,
                                   img_key_bias=img_key_bias, **opts)

    @staticmethod
    def backward(ctx, g_img, g_txt):
        *qkv, txt_bias, img_key_bias = ctx.saved_tensors
        o = ctx.opts
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(True) for x in qkv]
            outs = sta_gathered_attention(
                *ins, txt_bias, grid=o["grid"], tile=o["tile"],
                window=o["window"], scale=o["scale"],
                img_key_bias=img_key_bias)
            grads = torch.autograd.grad(outs, ins, (g_img, g_txt))
        return (*grads, None, None, None, None)


def sta_joint_attention_trainable(img_q, img_k, img_v, txt_q, txt_k, txt_v,
                                  txt_bias, *, grid, tile=(4, 8, 8),
                                  window=(3, 3, 3), scale=None,
                                  bound_mode="auto", qk_int8=False,
                                  score_bound=None, plain=False,
                                  img_key_bias=None):
    """`sta_joint_attention` with a sparse backward: the same forward (the
    kernel dispatch), differentiable through the gathered form. What
    `joint_attention(mode="sta")` and the ring x STA halo's slabs
    (`img_key_bias`, the wrap mask) route through, so fine-tuning under STA
    works; without a gradient to compute it is `sta_joint_attention`."""
    opts = dict(grid=tuple(grid), tile=tuple(tile), window=tuple(window),
                scale=scale, bound_mode=bound_mode, qk_int8=bool(qk_int8),
                plain=plain)
    qkv = (img_q, img_k, img_v, txt_q, txt_k, txt_v)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in qkv)):
        return sta_joint_attention(*qkv, txt_bias, score_bound=score_bound,
                                   img_key_bias=img_key_bias, **opts)
    if score_bound is not None:
        score_bound = torch.as_tensor(score_bound).detach()
    return _STATrainable.apply(*qkv, txt_bias, img_key_bias, score_bound,
                               opts)
