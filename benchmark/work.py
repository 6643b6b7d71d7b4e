"""The work a cell asks of the model, counted from its shapes: the patch
grid, the valid (query, key) pairs of sliding-tile attention, and the
operations of one denoise step as the model defines them (the same count
whatever kernels run). Part of the yardstick; imports nothing of the
program.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def patch_grid(cfg: dict, traffic: dict):
    """(T', H', W') of the DiT's patch grid for the traffic's video."""
    v, p = cfg["vae"], cfg["dit"]["patch_size"]
    t = (traffic["video_length"] - 1) // v["time_compression_ratio"] + 1
    s = v["spatial_compression_ratio"]
    return (t // p[0], traffic["height"] // s // p[1],
            traffic["width"] // s // p[2])


def tile_rows(grid, tile) -> np.ndarray:
    """Tokens inside the grid of each tile, [gt, gh, gw] (tiles from the
    grid's origin, the last ones ragged)."""
    per_axis = []
    for n, k in zip(grid, tile):
        g = -(-n // k)
        per_axis.append(np.minimum(k, n - k * np.arange(g)))
    a, b, c = per_axis
    return a[:, None, None] * b[None, :, None] * c[None, None, :]


def sta_image_pairs(grid, tile, window) -> int:
    """(image query, image key) pairs of sliding-tile attention per (batch,
    head): each query tile's tokens times the tokens of the tiles within
    the window around it, clipped at the grid's edges."""
    rows = tile_rows(grid, tile)
    keys = np.zeros_like(rows)
    gt, gh, gw = rows.shape
    pad = [(w // 2, w // 2) for w in window]
    padded = np.pad(rows, pad)
    for da in range(window[0]):
        for db in range(window[1]):
            for dc in range(window[2]):
                keys += padded[da:da + gt, db:db + gh, dc:dc + gw]
    return int((rows * keys).sum())


def linears(cfg: dict, n_img: int, lt: int, batch: int):
    """(rows, N, K) of every linear of one DiT forward, in order."""
    d = cfg["dit"]
    h = d["hidden_size"]
    m = int(h * d["mlp_width_ratio"])
    td, td2 = d["text_states_dim"], d["text_states_dim_2"]
    patch = int(np.prod(d["patch_size"])) * d["in_channels"]
    out = int(np.prod(d["patch_size"])) * d["out_channels"]
    b, bi, bt, bx = batch, batch * n_img, batch * lt, batch * (n_img + lt)
    ls = [(bi, h, patch), (b, h, 256), (b, h, h), (b, h, td2), (b, h, h),
          (bt, h, td), (b, h, 256), (b, h, h), (b, h, td), (b, h, h)]
    for _ in range(d["refiner_depth"]):
        ls += [(b, 2 * h, h), (bt, 3 * h, h), (bt, h, h), (bt, 4 * h, h),
               (bt, h, 4 * h)]
    for _ in range(d["mm_double_blocks_depth"]):
        for rows in (bi, bt):
            ls += [(b, 6 * h, h), (rows, 3 * h, h), (rows, h, h),
                   (rows, m, h), (rows, h, m)]
    for _ in range(d["mm_single_blocks_depth"]):
        ls += [(b, 3 * h, h), (bx, 3 * h, h), (bx, m, h), (bx, h, h),
               (bx, h, m)]
    ls += [(b, 2 * h, h), (bi, out, h)]
    return ls


def attention_pairs(cfg: dict, grid, lt: int, valid: Sequence[int]) -> int:
    """(query, key) pairs of one forward's attention, summed over the
    batch, per head: every query over the image keys and the valid text
    keys (the token refiner's over the valid text), sliding tiles for the
    image queries of the STA blocks."""
    d, sta = cfg["dit"], cfg["sta"]
    n_img = int(np.prod(grid))
    depth = (d["mm_double_blocks_depth"], d["mm_single_blocks_depth"])
    refiner = d["refiner_depth"] * sum(lt * max(v, 1) for v in valid)
    dense = sum((n_img + lt) * (n_img + v) for v in valid)
    if sta is None:
        return refiner + sum(depth) * dense
    n_sta = (depth[0] - sta["dense_double_blocks"]
             + depth[1] - sta["dense_single_blocks"])
    img = sta_image_pairs(grid, sta["tile"], sta["window"])
    sta_pairs = sum(img + n_img * v + lt * (n_img + v) for v in valid)
    return refiner + (sum(depth) - n_sta) * dense + n_sta * sta_pairs


def step_operations(cfg: dict, grid, lt: int, valid: Sequence[int]) -> float:
    """Operations of one CFG denoise step: 2*rows*N*K a linear, 4*D a
    (query, key) pair a head (Q.K^T and P.V)."""
    d = cfg["dit"]
    n_img = int(np.prod(grid))
    gemm = sum(2.0 * r * n * k for r, n, k in
               linears(cfg, n_img, lt, len(valid)))
    head_dim = d["hidden_size"] // d["heads_num"]
    return gemm + 4.0 * head_dim * d["heads_num"] * attention_pairs(
        cfg, grid, lt, valid)
