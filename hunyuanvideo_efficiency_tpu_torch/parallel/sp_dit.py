"""Sequence-parallel DiT sampling helpers over torch.distributed
(JAX counterpart: parallel/sp_dit.py; reference: the
`parallelize_transformer` patch, hyvideo/inference.py:40-104).

The latent travels as flat patch tokens [B, L, C*pt*ph*pw]
(`models.dit.patchify_raw`): each rank keeps its dp shard of the batch and
its ring-major block of the tokens (parallel/mesh.py), the RoPE rows of the
same tokens, and the whole text; `HYVideoDiT.forward_tokens(..., sp=groups)`
is one rank's token-sharded forward (the GLOBAL patch grid as token_grid),
its attention `usp_joint_attention`; `diffusion.pipeline.denoise_step(...,
sp=groups)` is one rank's step, its guidance rescale's moments `sp_mean`.
The Euler step is pointwise, so the latent stays token-sharded for every step
and is gathered once, before the VAE decode
(diffusion/pipeline.py:_denoise_sharded); the reference gathers it every
step (inference.py:97-100).
"""
from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .mesh import ParallelConfig, SPGroups, check_backend


def check_sp_compat(cfg, pcfg: ParallelConfig,
                    token_grid: Tuple[int, int, int], batch: int) -> None:
    """Whether (model, shape, layout) can shard; a readable error instead
    of a shape failure (the reference asserts the like in
    inference.py:166-175)."""
    n_tokens = int(np.prod(token_grid))
    sp = pcfg.sp_degree
    if n_tokens % sp:
        raise ValueError(
            f"token count {n_tokens} (grid {token_grid}) is not divisible "
            f"by the sequence-parallel degree {sp} "
            f"(ulysses {pcfg.ulysses_degree} x ring {pcfg.ring_degree})")
    if cfg.heads_num % pcfg.ulysses_degree:
        raise ValueError(
            f"heads_num {cfg.heads_num} not divisible by ulysses degree "
            f"{pcfg.ulysses_degree}")
    if batch % pcfg.dp_degree:
        raise ValueError(
            f"batch {batch} not divisible by dp degree {pcfg.dp_degree}")
    if cfg.attn_mode.startswith("sta") and pcfg.ring_degree > 1:
        r = pcfg.ring_degree
        tt = cfg.sta_tile[0]
        wt = cfg.sta_window[0]
        t = token_grid[0]
        if (wt % 2 == 0 or t % (r * tt) != 0
                or t // r < (wt // 2) * tt):
            raise ValueError(
                f"attn_mode='sta' with ring_degree {r} needs t-slab halo "
                f"exchange: T={t} must be divisible by ring*tile_t "
                f"({r}*{tt}), each slab (T/r={t // r} planes) must cover "
                f"the halo ({wt // 2}*{tt} planes), and the t window "
                f"({wt}) must be odd — use a pure-Ulysses factorization "
                f"for this shape instead")
        halo = (wt // 2) * tt
        if 2 * halo >= t // r:
            warnings.warn(
                f"attn_mode='sta' with ring_degree {r}: each rank attends "
                f"the queries of {t // r + 2 * halo} t-planes (its slab of "
                f"{t // r} and two halos of {halo}) and keeps {t // r}, at "
                f"least twice the work of its slab; a pure-Ulysses "
                f"factorization of this shape does 1/{r} of the grid's "
                f"work a rank", stacklevel=2)


def _cfg_order(b2: int, dp: int) -> np.ndarray:
    b = b2 // 2
    bs = b // dp
    return np.concatenate([
        np.concatenate([np.arange(d * bs, (d + 1) * bs),
                        b + np.arange(d * bs, (d + 1) * bs)])
        for d in range(dp)])


def cfg_reorder_for_dp(x: torch.Tensor, dp: int) -> torch.Tensor:
    """Reorders a CFG batch [neg(B) | pos(B)] so that dp equal slices of the
    leading axis each hold their own [neg | pos] pair."""
    if dp <= 1:
        return x
    return x[torch.from_numpy(_cfg_order(x.shape[0], dp)).to(x.device)]


def cfg_unreorder_for_dp(x: torch.Tensor, dp: int) -> torch.Tensor:
    """Inverse of cfg_reorder_for_dp."""
    if dp <= 1:
        return x
    inv = np.argsort(_cfg_order(x.shape[0], dp))
    return x[torch.from_numpy(inv).to(x.device)]


def cfg_local(x: torch.Tensor, g: SPGroups) -> torch.Tensor:
    """This rank's dp slice of a CFG batch, [neg_d | pos_d]."""
    dp = g.pcfg.dp_degree
    x = cfg_reorder_for_dp(x, dp)
    n = x.shape[0] // dp
    return x[g.dp_index * n:(g.dp_index + 1) * n]


def sp_mean(x: torch.Tensor, g: SPGroups) -> torch.Tensor:
    """Each sample's mean over the whole token sequence of the sp group
    (equal shard sizes: the mean of the shards' means), kept as
    [B, 1, ...]; the guidance rescale's `mean` under sequence
    parallelism."""
    x = x.mean(dim=tuple(range(1, x.ndim)), keepdim=True)
    if g.sp is None:
        return x
    x = x.contiguous()
    check_backend(g.sp, x)
    dist.all_reduce(x, group=g.sp)
    return x / g.pcfg.sp_degree


def from_rank0(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Global rank 0's `x` on every rank: every rank runs the text towers,
    and the embeddings they condition on must be one (the stand-in
    HashTokenizer hashes words with a per-process salt)."""
    if x is None:
        return None
    x = x.contiguous()
    check_backend(None, x)
    dist.broadcast(x, src=0)
    return x


def gather_tokens(local: torch.Tensor, g: SPGroups) -> torch.Tensor:
    """The one gather of a run: every rank's [B_loc, L_loc, C] shard ->
    [B, L, C] on every rank, over sp (token blocks put back in ring-major
    order) and then dp."""
    pcfg = g.pcfg
    local = local.contiguous()
    full = local
    if g.sp is not None:
        check_backend(g.sp, local)
        parts = [torch.empty_like(local) for _ in g.sp_ranks]
        dist.all_gather(parts, local, group=g.sp)
        blocks: List[Optional[torch.Tensor]] = [None] * pcfg.sp_degree
        for rank, part in zip(g.sp_ranks, parts):
            _, i, j = pcfg.coords(rank)
            blocks[pcfg.token_block(i, j)] = part
        full = torch.cat(blocks, dim=1)
    if g.dp is not None:
        check_backend(g.dp, full)
        parts = [torch.empty_like(full) for _ in g.dp_ranks]
        dist.all_gather(parts, full, group=g.dp)
        full = torch.cat(parts, dim=0)
    return full
