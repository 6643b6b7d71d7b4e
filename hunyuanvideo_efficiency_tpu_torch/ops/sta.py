"""Sliding Tile Attention (STA) for the image queries of the joint [img | txt]
sequence (JAX counterpart: ops/sta.py).

Video tokens of a (T, H, W) patch grid are cut into (tt, th, tw) tiles; the
queries of a tile attend to the image keys of the tiles inside a sliding
window of tiles around it, plus every text key. Text queries keep full
attention over [img | txt]. The tile plan (`tile_plan`) is host numpy,
static per (grid, tile, window), and equal to the JAX package's.

Five kernels with one CUDA source (`csrc/sta_attention.cu`, template
flags DIRECT, RUNNING and QUANT), each a wrapper here with a `LAUNCHES`
count:

* `sta_direct` (DIRECT=1, RUNNING=0) replaces `_sta_nomax_direct_kernel`:
  static exponent offset C, q/k/v read and out written in the row-major
  token grid, text keys folded last. The main path's kernel under QK-norm.
* `sta_permuted_static` (DIRECT=0, RUNNING=0) replaces
  `_sta_nomax_fused_kernel` and `_sta_nomax_kernel`, which compute the same
  function: static offset over tile-major permuted q and the concatenated
  [img tiles | text] keys `kcat`, the text block(s) being extra slots of
  the neighbour table.
* `sta_permuted_running` (DIRECT=0, RUNNING=1) replaces `_sta_kernel`: the
  same layout with a running max, for models without QK-norm.
* `sta_direct_int8` and `sta_permuted_static_int8` (QUANT=1) are the
  `quant=True` arms of the first two (`--attn-mode sta_int8`): Q.K^T in
  int8 with one scale per (batch, head, tile) of the queries and of the
  keys; the direct arm's text keys stay bf16, the permuted arm quantizes
  its text blocks like image key tiles. The two arms compute different
  functions, and each wrapper follows its JAX arm.

On CPU tensors each wrapper runs the plain version (`sta_attention_plain`,
built on `sta_permuted_plain`): neighbour tiles gathered per chunk of query
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

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from . import cuda_lib
from .flash_attention import (_DTYPE_CODE, _as_rows, flash_attention,
                              int8_bound_inflation, merge_flash_states)

NEG_INF = -1e30
PLAIN_TILE_CHUNK = 8   # query tiles per step of the plain version: at 540p
                       # (24 heads) its scores take ~3 GB per step


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
    sc = xf.abs().amax(dim=(2, 4)).clamp_min(1e-6) / 127.0
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


def _geometry(name, grid, tile, d):
    block = tile[0] * tile[1] * tile[2]
    if d not in (64, 128):
        raise ValueError(f"{name} takes head_dim 64 or 128, got {d}")
    if block % 64:
        raise ValueError(f"{name}: tile {tile} has {block} tokens, not a "
                         f"multiple of 64")
    return block


def _launch(name, direct, running, q, k, v, out, tk, tv, kb, tb, c, nbr,
            grid, tile, lt, scale, quant=False):
    b, _, hh, d = q.shape
    block = tile[0] * tile[1] * tile[2]
    n_qtiles = nbr.shape[0]
    n_ktiles = k.shape[1] // block if not direct else n_qtiles
    sq = sk = None
    if quant:   # scratch for the kernel's tile-scale pre-pass
        sq = torch.empty((b, hh, n_qtiles), dtype=torch.float32,
                         device=q.device)
        sk = torch.empty((b, hh, n_ktiles), dtype=torch.float32,
                         device=q.device)
    lib = cuda_lib.library("sta_attention")

    def ptr(x):
        return x.data_ptr() if x is not None else None

    def strides(x):
        return (x.stride(0), x.stride(1)) if x is not None else (0, 0)

    err = lib.hv_sta_attention_fwd(
        _DTYPE_CODE[q.dtype], int(direct), int(running), int(quant), d,
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(tk), ptr(tv), ptr(kb), ptr(tb),
        ptr(c), ptr(nbr), ptr(sq), ptr(sk), b, hh, nbr.shape[1], lt,
        n_ktiles, *grid, *tile,
        *strides(q), *strides(k), *strides(v), *strides(tk), *strides(tv),
        out.stride(0), out.stride(1), kb.stride(0) if kb is not None else 0,
        float(scale), cuda_lib.stream_ptr(q.device))
    cuda_lib.check(err, name)


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
    _geometry(name, grid, tile, d)
    if s_img != grid[0] * grid[1] * grid[2] or img_k.shape != img_q.shape \
            or img_v.shape != img_q.shape \
            or txt_k.shape != (b, lt, hh, d) or txt_v.shape != txt_k.shape:
        raise ValueError(f"{name}: bad shapes q {tuple(img_q.shape)} "
                         f"for grid {grid}, txt {tuple(txt_k.shape)}")
    q, k, v = _as_rows(img_q), _as_rows(img_k), _as_rows(img_v)
    tk, tv = _as_rows(txt_k), _as_rows(txt_v)
    kb = (img_key_bias.reshape(b, s_img).float().contiguous()
          if img_key_bias is not None else None)
    tb = (txt_bias.reshape(b, lt).float().contiguous()
          if txt_bias is not None else None)
    cc = c.float().expand(b, hh).contiguous()
    nbr = _device_nbr(grid, tile, window, 0, q.device)
    out = torch.empty((b, s_img, hh * d), dtype=q.dtype, device=q.device)
    _launch(name, True, False, q, k, v, out, tk, tv, kb, tb, cc, nbr, grid,
            tile, lt, scale, quant)
    return out


def sta_direct(img_q, img_k, img_v, txt_k, txt_v, txt_bias, c, grid, tile,
               window, scale: float, img_key_bias=None) -> torch.Tensor:
    """B4: static-offset STA in the row-major token grid. img_q/k/v
    [B, S_img, H, D]; txt_k/v [B, Lt, H, D]; txt_bias [B, 1, 1, Lt] (or
    [B, Lt]) fp32 or None; c [B, H] fp32 offsets; img_key_bias optional
    [B, S_img] fp32. Returns [B, S_img, H*D]. Kernel on CUDA tensors, plain
    version on CPU tensors."""
    out = _direct("sta_direct", False, img_q, img_k, img_v, txt_k, txt_v,
                  txt_bias, c, grid, tile, window, scale, img_key_bias)
    if img_q.device.type != "cpu":
        sta_direct.LAUNCHES += 1
    return out


sta_direct.LAUNCHES = 0


def sta_direct_int8(img_q, img_k, img_v, txt_k, txt_v, txt_bias, c, grid,
                    tile, window, scale: float,
                    img_key_bias=None) -> torch.Tensor:
    """B4's int8 arm: as `sta_direct` with the image Q.K^T in int8 (tile
    scales) and the text keys in the input type; c must bound the int8
    scores (inflated). Kernel on CUDA tensors, plain version on CPU."""
    out = _direct("sta_direct_int8", True, img_q, img_k, img_v, txt_k, txt_v,
                  txt_bias, c, grid, tile, window, scale, img_key_bias)
    if img_q.device.type != "cpu":
        sta_direct_int8.LAUNCHES += 1
    return out


sta_direct_int8.LAUNCHES = 0


def _permuted(name, running, qp, kcat, vcat, kb, c, grid, tile, window,
              scale, quant=False):
    grid, tile, window = tuple(grid), tuple(tile), tuple(window)
    if qp.device.type == "cpu":
        return sta_permuted_plain(qp, kcat, vcat, kb, grid, tile, window,
                                  scale, c, qk_int8=quant)
    _check(name, (("qp", qp), ("kcat", kcat), ("vcat", vcat)), qp.dtype)
    b, s_pad, hh, d = qp.shape
    block = _geometry(name, grid, tile, d)
    plan = tile_plan(grid, tile, window, kcat.shape[1] - s_pad)
    if s_pad != plan["n_tiles"] * block or vcat.shape != kcat.shape \
            or kcat.shape[0::2] != (b, hh) or kcat.shape[-1] != d \
            or (kcat.shape[1] - s_pad) % block \
            or kb.shape != (b, kcat.shape[1]):
        raise ValueError(f"{name}: bad shapes qp {tuple(qp.shape)} kcat "
                         f"{tuple(kcat.shape)} kb {tuple(kb.shape)} for "
                         f"grid {grid}, tile {tile}")
    q, k, v = _as_rows(qp), _as_rows(kcat), _as_rows(vcat)
    kbf = kb.float().contiguous()
    cc = None if running else c.float().expand(b, hh).contiguous()
    nbr = _device_nbr(grid, tile, window, kcat.shape[1] - s_pad, q.device)
    out = torch.empty((b, s_pad, hh * d), dtype=q.dtype, device=q.device)
    _launch(name, False, running, q, k, v, out, None, None, kbf, None, cc,
            nbr, grid, tile, 0, scale, quant)
    return out


def sta_permuted_static(qp, kcat, vcat, kb, c, grid, tile, window,
                        scale: float) -> torch.Tensor:
    """B6a/B6b: static-offset STA on the tile-major layout of
    `permuted_operands`; c [B, H] fp32. Returns [B, S_pad, H*D] tile-major,
    padding rows zero. Kernel on CUDA tensors, plain version on CPU."""
    out = _permuted("sta_permuted_static", False, qp, kcat, vcat, kb, c,
                    grid, tile, window, scale)
    if qp.device.type != "cpu":
        sta_permuted_static.LAUNCHES += 1
    return out


sta_permuted_static.LAUNCHES = 0


def sta_permuted_static_int8(qp, kcat, vcat, kb, c, grid, tile, window,
                             scale: float) -> torch.Tensor:
    """B6's int8 arm: as `sta_permuted_static` with Q.K^T in int8, every
    key tile of kcat (text blocks included) quantized with its own scale; c
    must bound the int8 scores (inflated). Kernel on CUDA tensors, plain
    version on CPU."""
    out = _permuted("sta_permuted_static_int8", False, qp, kcat, vcat, kb, c,
                    grid, tile, window, scale, quant=True)
    if qp.device.type != "cpu":
        sta_permuted_static_int8.LAUNCHES += 1
    return out


sta_permuted_static_int8.LAUNCHES = 0


def sta_permuted_running(qp, kcat, vcat, kb, grid, tile, window,
                         scale: float) -> torch.Tensor:
    """B7: running-max STA on the tile-major layout of `permuted_operands`.
    Returns [B, S_pad, H*D] tile-major, padding rows zero. Kernel on CUDA
    tensors, plain version on CPU."""
    out = _permuted("sta_permuted_running", True, qp, kcat, vcat, kb, None,
                    grid, tile, window, scale)
    if qp.device.type != "cpu":
        sta_permuted_running.LAUNCHES += 1
    return out


sta_permuted_running.LAUNCHES = 0


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

    score_bound: bound on |q.k|*scale broadcastable to [B, H]; without one
    the Cauchy-Schwarz bound of the image-query and all-key row norms.
    img_key_bias: optional additive fp32 [B, S_img] on the image keys, for
    image and text queries alike. plain=True routes the image queries to
    `sta_attention_plain` (a reference for checks on the card).
    slot_block, head_block: accepted for signature parity with the JAX
    function; the CUDA kernel's tiles are fixed at 64 x 64.
    ring and lane_rotate (TPU DMA-elision plans) are not ported.
    """
    del slot_block, head_block
    if qk_int8 and bound_mode != "static":
        raise ValueError("sta qk_int8 requires bound_mode='static' "
                         "(QK-norm score bound)")
    if ring:
        _not_ported("the STA ring-buffer kernel (ring=True)")
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
        if plain:
            img_out = sta_attention_plain(img_q, img_k, img_v, txt_k, txt_v,
                                          txt_bias, grid, tile, window, scale,
                                          c, img_key_bias, qk_int8=qk_int8)
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
                           scale=None, tile_chunk: int = 32):
    """Differentiable plain-PyTorch STA with the tile plan of the kernels
    (JAX `sta_gathered_attention`): per query tile the neighbour key/value
    tiles are gathered into one key set, the text keys appended, and an
    fp32 softmax runs per tile, so autograd derives the sparse backward (the
    gather's transpose scatter-adds dK/dV). `tile_chunk` query tiles are
    processed per step. Returns (img_out [B, S_img, H*D], txt_out
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

    full_kb = torch.cat([torch.zeros((b, s_img), device=dev), tb_row],
                        dim=1)[:, None, None, :]
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
    on the saved inputs gives the sparse attention gradients. txt_bias and
    score_bound (which only shifts the kernels' exponent offset) get no
    gradient."""

    @staticmethod
    def forward(ctx, iq, ik, iv, tq, tk, tv, txt_bias, score_bound, opts):
        ctx.save_for_backward(iq, ik, iv, tq, tk, tv, txt_bias)
        ctx.opts = opts
        return sta_joint_attention(iq, ik, iv, tq, tk, tv, txt_bias,
                                   score_bound=score_bound, **opts)

    @staticmethod
    def backward(ctx, g_img, g_txt):
        *qkv, txt_bias = ctx.saved_tensors
        o = ctx.opts
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(True) for x in qkv]
            outs = sta_gathered_attention(
                *ins, txt_bias, grid=o["grid"], tile=o["tile"],
                window=o["window"], scale=o["scale"])
            grads = torch.autograd.grad(outs, ins, (g_img, g_txt))
        return (*grads, None, None, None)


def sta_joint_attention_trainable(img_q, img_k, img_v, txt_q, txt_k, txt_v,
                                  txt_bias, *, grid, tile=(4, 8, 8),
                                  window=(3, 3, 3), scale=None,
                                  bound_mode="auto", qk_int8=False,
                                  score_bound=None, plain=False):
    """`sta_joint_attention` with a sparse backward: the same forward (the
    kernel dispatch), differentiable through the gathered form. What
    `joint_attention(mode="sta")` routes through, so fine-tuning under STA
    works; without a gradient to compute it is `sta_joint_attention`."""
    opts = dict(grid=tuple(grid), tile=tuple(tile), window=tuple(window),
                scale=scale, bound_mode=bound_mode, qk_int8=bool(qk_int8),
                plain=plain)
    qkv = (img_q, img_k, img_v, txt_q, txt_k, txt_v)
    if not (torch.is_grad_enabled() and any(x.requires_grad for x in qkv)):
        return sta_joint_attention(*qkv, txt_bias, score_bound=score_bound,
                                   **opts)
    if score_bound is not None:
        score_bound = torch.as_tensor(score_bound).detach()
    return _STATrainable.apply(*qkv, txt_bias, score_bound, opts)
