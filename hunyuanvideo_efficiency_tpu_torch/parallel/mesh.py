"""Parallel degrees, the rank layout and the process subgroups (JAX
counterpart: parallel/mesh.py; reference: hyvideo/inference.py:156-181).

JAX builds one device mesh with the axes (dp, ulysses, ring); here one
process drives one device and the same layout is a set of
`torch.distributed` subgroups over the ranks:

  dp      data parallel (videos, and the CFG halves of each)
  ulysses all_to_all head scatter / sequence gather
  ring    K/V rotation by point-to-point sends

A rank's coordinates follow the mesh's reshape (JAX mesh.py:66-68): dp
outermost, then ulysses, then ring, so rank = (d * u + i) * r + j.

Token order is ring-major (JAX SP_AXES, mesh.py:29-38): rank (i, j) of a
dp shard holds flat token block j * u + i. After the Ulysses all_to_all,
which concatenates the u blocks of one ring index in ulysses order, every
ring rank holds one contiguous run of t-planes; the ring x STA halo
exchange (sp_attention.ring_sta_halo) needs that. Dense attention does not
depend on token order, so only ring x STA shows a wrong layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

@dataclass(frozen=True)
class ParallelConfig:
    """Parallelism degrees (reference flags --ulysses-degree/--ring-degree,
    hyvideo/config.py:364-381), with the outer dp degree of the JAX
    package."""
    dp_degree: int = 1
    ulysses_degree: int = 1
    ring_degree: int = 1

    @property
    def sp_degree(self) -> int:
        return self.ulysses_degree * self.ring_degree

    @property
    def world_size(self) -> int:
        return self.dp_degree * self.sp_degree

    def coords(self, rank: int) -> Tuple[int, int, int]:
        """(dp, ulysses, ring) index of `rank`."""
        r, u = self.ring_degree, self.ulysses_degree
        return rank // (u * r), (rank // r) % u, rank % r

    def rank_of(self, d: int, i: int, j: int) -> int:
        return (d * self.ulysses_degree + i) * self.ring_degree + j

    def token_block(self, i: int, j: int) -> int:
        """Flat token block of ulysses index i, ring index j (ring-major)."""
        return j * self.ulysses_degree + i


def parse_mesh_shape(spec: str) -> ParallelConfig:
    """"dp:2,ulysses:2,ring:2" -> ParallelConfig; `sp` is an alias of
    `ulysses` (JAX inference.py:105-121)."""
    degrees = {"dp": 1, "ulysses": 1, "ring": 1}
    for part in spec.split(","):
        name, _, val = part.partition(":")
        name = {"sp": "ulysses"}.get(name.strip(), name.strip())
        if name not in degrees:
            raise ValueError(f"Unknown mesh axis {name!r} in --mesh-shape "
                             f"{spec!r}")
        degrees[name] = int(val)
    return ParallelConfig(dp_degree=degrees["dp"],
                          ulysses_degree=degrees["ulysses"],
                          ring_degree=degrees["ring"])


def parallel_config(args) -> ParallelConfig:
    """The degrees an InferenceArgs asks for: --mesh-shape, else
    --ulysses-degree x --ring-degree."""
    if getattr(args, "mesh_shape", None):
        return parse_mesh_shape(args.mesh_shape)
    return ParallelConfig(ulysses_degree=args.ulysses_degree,
                          ring_degree=args.ring_degree)


@dataclass
class SPGroups:
    """This rank's place in the layout and its subgroups (None where the
    degree is 1). `*_ranks` are the global ranks of each group in group
    order."""
    pcfg: ParallelConfig
    rank: int
    dp_index: int
    ulysses_index: int
    ring_index: int
    ulysses: Optional[dist.ProcessGroup]
    ring: Optional[dist.ProcessGroup]
    sp: Optional[dist.ProcessGroup]
    dp: Optional[dist.ProcessGroup]
    ring_ranks: List[int]
    sp_ranks: List[int]
    dp_ranks: List[int]

    @property
    def u(self) -> int:
        return self.pcfg.ulysses_degree

    @property
    def r(self) -> int:
        return self.pcfg.ring_degree

    def token_range(self, n_tokens: int) -> slice:
        """This rank's slice of the flat token sequence."""
        n = n_tokens // self.pcfg.sp_degree
        blk = self.pcfg.token_block(self.ulysses_index, self.ring_index)
        return slice(blk * n, (blk + 1) * n)

    def batch_range(self, batch: int) -> slice:
        """This rank's slice of a batch sharded over dp."""
        n = batch // self.pcfg.dp_degree
        return slice(self.dp_index * n, (self.dp_index + 1) * n)


def make_groups(pcfg: ParallelConfig) -> SPGroups:
    """Builds the subgroups of `pcfg` on the initialized default group,
    whose size must be pcfg.world_size. Every rank calls this, and every
    rank creates every group in the same order (dist.new_group's rule):
    one per ulysses row, one per ring row, one per sp group, one per dp
    group."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"sequence parallelism over {pcfg.world_size} ranks needs a "
            f"process group: run under torchrun --nproc_per_node "
            f"{pcfg.world_size}")
    world = dist.get_world_size()
    if world != pcfg.world_size:
        raise ValueError(
            f"process group has {world} ranks, but dp {pcfg.dp_degree} x "
            f"ulysses {pcfg.ulysses_degree} x ring {pcfg.ring_degree} = "
            f"{pcfg.world_size}")
    rank = dist.get_rank()
    dp, u, r = pcfg.dp_degree, pcfg.ulysses_degree, pcfg.ring_degree
    mine = pcfg.coords(rank)
    found = {}

    def build(kind, ranks_list):
        for ranks in ranks_list:
            grp = dist.new_group(ranks) if len(ranks) > 1 else None
            if rank in ranks:
                found[kind] = (grp, ranks)

    build("ulysses", [[pcfg.rank_of(d, i, j) for i in range(u)]
                      for d in range(dp) for j in range(r)])
    build("ring", [[pcfg.rank_of(d, i, j) for j in range(r)]
                   for d in range(dp) for i in range(u)])
    build("sp", [[pcfg.rank_of(d, i, j) for i in range(u) for j in range(r)]
                 for d in range(dp)])
    build("dp", [[pcfg.rank_of(d, i, j) for d in range(dp)]
                 for i in range(u) for j in range(r)])
    return SPGroups(pcfg, rank, *mine,
                    ulysses=found["ulysses"][0], ring=found["ring"][0],
                    sp=found["sp"][0], dp=found["dp"][0],
                    ring_ranks=found["ring"][1], sp_ranks=found["sp"][1],
                    dp_ranks=found["dp"][1])


def check_backend(group: Optional[dist.ProcessGroup],
                  x: torch.Tensor) -> None:
    """CUDA tensors travel over NCCL and CPU tensors over gloo; anything
    else raises instead of falling back."""
    backend = str(dist.get_backend(group))
    want = "nccl" if x.is_cuda else "gloo"
    if want not in backend:
        raise RuntimeError(f"{x.device.type} tensor on a {backend} group: "
                           f"sequence parallelism runs {want} for it")
