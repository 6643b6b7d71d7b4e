"""The collectives of the scale-out memory tiers (the weight-sharded DiT
stacks, parallel/weight_shard.py; the tensor-parallel Llama tower,
models/text/llama.py; the tile-sharded VAE, models/vae.py), behind one
interface with two forms:

  GroupComm(group)  one rank of a process group (NCCL for CUDA tensors,
                    gloo for CPU ones): this process computes its own rank,
                    and each reduction, gather or exchange is a collective;
  LocalComm(world)  `world` ranks that one process runs one after another
                    (one card standing in for several: chip_smoke.py's rank
                    math): the same per-rank arithmetic, each reduction a
                    sum or max over the ranks' parts in rank order.

A caller computes one part for each rank in `comm.ranks` (its own rank
under GroupComm, every rank under LocalComm) and hands the list over.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import check_backend

# tile dtypes a rank may exchange, by code (a rank that owns no tile learns
# the dtype from the others)
_DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


class GroupComm:
    """This rank of the process group `group` (None: the default group)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.ranks = [self.rank]

    def _global(self, r: int) -> int:
        return (r if self.group is None
                else dist.get_global_rank(self.group, r))

    def _reduce(self, parts: Sequence[torch.Tensor], op) -> torch.Tensor:
        (x,) = parts
        x = x.contiguous()
        check_backend(self.group, x)
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return self._reduce(parts, dist.ReduceOp.SUM)

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return self._reduce(parts, dist.ReduceOp.MAX)

    def broadcast0(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's x on every rank."""
        x = x.contiguous()
        check_backend(self.group, x)
        dist.broadcast(x, src=self._global(0), group=self.group)
        return x

    def keep(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Copies of this rank's part of `parts` (one a rank)."""
        return [parts[self.rank].clone()]

    def gather_into(self, out: torch.Tensor,
                    kept: Sequence[torch.Tensor]) -> None:
        """Every rank's kept part, in rank order, into `out` (one
        all_gather_into_tensor)."""
        check_backend(self.group, out)
        gather = getattr(dist, "all_gather_single", None) \
            or dist.all_gather_into_tensor
        gather(out, kept[0], group=self.group)

    def share_tiles(self, own: Dict[int, torch.Tensor], n: int,
                    dev: torch.device) -> List[torch.Tensor]:
        """Tiles 0..n-1 on every rank, each computed by its owner (`own`:
        this rank's, on `dev`): one all_reduce of every tile's shape and
        dtype code, then a broadcast from each tile's owner."""
        meta = torch.zeros(n, 7, dtype=torch.int64, device=dev)
        for k, t in own.items():
            meta[k, :t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
            meta[k, 6] = _DTYPES.index(t.dtype) + 1
        meta = self.sum([meta]).tolist()
        out = []
        for k in range(n):
            if k in own:
                t = own[k].contiguous()
            else:
                shape = [s for s in meta[k][:6] if s]
                t = torch.empty(shape, dtype=_DTYPES[meta[k][6] - 1],
                                device=dev)
            check_backend(self.group, t)
            dist.broadcast(t, src=self._global(tile_owner(k, self.world)),
                           group=self.group)
            out.append(t)
        return out


class LocalComm:
    """`world` ranks run in turn by this process."""

    def __init__(self, world: int):
        self.world = world
        self.ranks = list(range(world))

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.add, parts)

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        return functools.reduce(torch.maximum, parts)

    def broadcast0(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def keep(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [p.clone() for p in parts]

    def gather_into(self, out: torch.Tensor,
                    kept: Sequence[torch.Tensor]) -> None:
        torch.cat(list(kept), out=out)

    def share_tiles(self, own: Dict[int, torch.Tensor], n: int,
                    dev: torch.device) -> List[torch.Tensor]:
        return [own[k] for k in range(n)]


def tile_owner(k: int, world: int) -> int:
    """The rank that computes tile k of a tiled VAE call: round robin over
    the tiles in row-major order, so each rank takes at most ceil(n /
    world) tiles, the least any assignment can give."""
    return k % world


def run_tiles(comm, n: int, compute: Callable[[int], torch.Tensor],
              dev: torch.device) -> List[torch.Tensor]:
    """compute(k) for each of the n tiles, each by its owner among
    comm.ranks, then every tile on every rank, on `dev` (comm None: all
    here)."""
    if comm is None:
        return [compute(k) for k in range(n)]
    own = {k: compute(k) for r in comm.ranks for k in range(n)
           if tile_owner(k, comm.world) == r}
    return comm.share_tiles(own, n, dev)
