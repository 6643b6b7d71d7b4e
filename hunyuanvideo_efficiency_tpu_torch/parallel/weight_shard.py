"""Weight-sharded DiT block stacks, the `--shard-dit-weights` memory tier
(JAX parallel/sp_dit.py:300-375 `shard_dit_params` / `make_param_gather`,
models/dit.py:991-1018 `scan_range`).

The ranks of one sp group (ulysses x ring; not dp, as in JAX) each keep
1/sp of the `double_blocks` and `single_blocks` parameters and buffers;
everything outside the stacks (img_in, txt_in, the embedders,
final_layer) stays replicated. A stack is cut into chunks of ceil(depth /
4) blocks (JAX weight_chunks=4; under STA with dense anchor blocks the
dense head and the STA tail are chunked separately, as JAX splits its
scan), and just before a chunk's first block runs, the chunk is gathered
back to full size (HYVideoDiT.forward_tokens calls `fetch`).

The torch form. A chunk's tensors are packed, per dtype (bf16 weights and
biases, int8 codes with their fp32 scale_out, fp8 codes, packed int4), into
one byte buffer: each tensor at an offset aligned to ALIGN bytes, the
buffer padded to a multiple of ALIGN * sp, and rank r keeps its r-th equal
part. One transient buffer per dtype, the size of the largest chunk's,
holds the gathered chunk, and every block's tensors are views into it at
their offsets (the blocks of different chunks share its memory; one chunk
is live at a time). A fetch is one `all_gather_into_tensor` a dtype (of
the bytes, which also carries fp8 codes over any backend), never one a
tensor: 60 blocks of ~20 tensors would be 1,200 small collectives. The
gather is blocking; overlapping the next chunk's gather with this chunk's
compute is left for later. The gathered bytes are the packed bytes, so the
sharded forward equals the replicated one bit for bit.

A rank's persistent stack bytes are the sum of its parts: ceil(stack / sp)
plus the alignment padding (`WeightShards.shard_bytes`); the transient
chunk adds `transient_bytes`. `build_sharded_dit` builds this rank's model
without the whole DiT ever on the card: a chunk at a time takes its weights
(a host state dict, or random ones drawn in HYVideoDiT.init_weights's
order, so the values are the replicated build's), its weight tiers, and
is cut. `shard_dit` cuts an existing model's stacks in place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

ALIGN = 256          # bytes: each tensor's offset in a packed chunk
WEIGHT_CHUNKS = 4    # chunks a stack (JAX dit_forward_tokens weight_chunks)
STACKS = ("double_blocks", "single_blocks")


def chunk_plan(depth: int, n_dense: int = 0, sta: bool = False,
               chunks: int = WEIGHT_CHUNKS) -> List[Tuple[int, int]]:
    """(start, stop) of each chunk of a stack of `depth` blocks: ceil(n /
    chunks) blocks a chunk; under STA with n_dense > 0 the dense head and
    the STA tail separately (JAX models/dit.py:1003-1018)."""
    def split(a, b):
        step = max(1, -(-(b - a) // chunks))
        return [(c, min(c + step, b)) for c in range(a, b, step)]

    if sta and n_dense > 0:
        return split(0, min(n_dense, depth)) + split(min(n_dense, depth),
                                                     depth)
    return split(0, depth)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


class _Chunk:
    """One chunk's layout: per dtype the kept parts and the packed size,
    and each tensor's (module, kind, name, shape, dtype, offset, bytes)."""

    def __init__(self):
        self.buckets: Dict[torch.dtype, Tuple[List[torch.Tensor], int]] = {}
        self.entries: List[tuple] = []
        self.tensor_bytes = 0


class WeightShards:
    """The stacks' shards of one model over `comm` (parallel/comm.py:
    GroupComm over the sp group, or LocalComm for ranks run in turn), on
    `device`. Built by add_chunk (one chunk at a time, in forward order)
    and finish."""

    GATHERS = 0     # all_gather_into_tensor calls (one a chunk a dtype)

    def __init__(self, comm, device):
        self.comm = comm
        self.device = torch.device(device)
        self.chunks: List[_Chunk] = []
        self.start_of: Dict[Tuple[str, int], _Chunk] = {}
        self.buffers: Dict[torch.dtype, torch.Tensor] = {}

    @torch.no_grad()
    def add_chunk(self, stack: str, start: int,
                  blocks: Sequence[nn.Module]) -> None:
        """Packs the materialized `blocks` (stack[start:start+n]), keeps
        this rank's parts on the device and frees the blocks' tensors (they
        become views into the transient buffer at `finish`)."""
        chunk = _Chunk()
        by_dtype: Dict[torch.dtype, list] = {}
        for blk in blocks:
            for mod in blk.modules():
                for kind, table in (("p", mod._parameters),
                                    ("b", mod._buffers)):
                    for name, t in table.items():
                        if t is not None:
                            by_dtype.setdefault(t.dtype, []).append(
                                (mod, kind, name, t))
        world = self.comm.world
        for dtype, items in by_dtype.items():
            offsets, off = [], 0
            for _, _, _, t in items:
                offsets.append(off)
                off += _round_up(t.numel() * t.element_size(), ALIGN)
            total = _round_up(off, ALIGN * world)
            flat = torch.zeros(total, dtype=torch.uint8, device=self.device)
            for (mod, kind, name, t), o in zip(items, offsets):
                nb = t.numel() * t.element_size()
                flat[o:o + nb].copy_(
                    t.detach().contiguous().reshape(-1).view(torch.uint8))
                chunk.entries.append((mod, kind, name, tuple(t.shape),
                                      dtype, o, nb))
                chunk.tensor_bytes += nb
                meta = torch.empty(t.shape, dtype=dtype, device="meta")
                if kind == "p":
                    mod._parameters[name] = nn.Parameter(
                        meta, requires_grad=False)
                else:
                    mod._buffers[name] = meta
            chunk.buckets[dtype] = (self.comm.keep(list(flat.view(
                world, -1))), total)
            del flat
        self.chunks.append(chunk)
        self.start_of[(stack, start)] = chunk

    def finish(self) -> "WeightShards":
        """One transient buffer per dtype, the size of the largest chunk's
        packed bytes, and every block tensor a view into it."""
        sizes: Dict[torch.dtype, int] = {}
        for c in self.chunks:
            for dtype, (_, total) in c.buckets.items():
                sizes[dtype] = max(sizes.get(dtype, 0), total)
        self.buffers = {dtype: torch.empty(n, dtype=torch.uint8,
                                           device=self.device)
                        for dtype, n in sizes.items()}
        self._bind()
        return self

    def _bind(self) -> None:
        for c in self.chunks:
            for mod, kind, name, shape, dtype, o, nb in c.entries:
                view = self.buffers[dtype][o:o + nb].view(dtype).reshape(
                    shape)
                if kind == "p":
                    mod._parameters[name] = nn.Parameter(
                        view, requires_grad=False)
                else:
                    mod._buffers[name] = view

    def fetch(self, stack: str, i: int) -> None:
        """Gathers the chunk that starts at block i of `stack`, if one
        does, into the transient buffers."""
        chunk = self.start_of.get((stack, i))
        if chunk is None:
            return
        for dtype, (kept, total) in chunk.buckets.items():
            self.comm.gather_into(self.buffers[dtype][:total], kept)
            WeightShards.GATHERS += 1

    @property
    def shard_bytes(self) -> int:
        """This rank's persistent bytes of the stacks."""
        return sum(total // self.comm.world for c in self.chunks
                   for _, total in c.buckets.values())

    @property
    def stack_bytes(self) -> int:
        """The stacks' own bytes (every tensor once, no padding)."""
        return sum(c.tensor_bytes for c in self.chunks)

    @property
    def transient_bytes(self) -> int:
        return sum(b.numel() for b in self.buffers.values())

    def to(self, device) -> "WeightShards":
        """The kept parts and the transient buffers on `device` (the
        pipeline's --use-cpu-offload), the block views bound anew."""
        device = torch.device(device)
        if device == self.device:
            return self
        for c in self.chunks:
            for dtype, (kept, total) in list(c.buckets.items()):
                c.buckets[dtype] = ([p.to(device) for p in kept], total)
        self.buffers = {dtype: torch.empty(b.numel(), dtype=torch.uint8,
                                           device=device)
                        for dtype, b in self.buffers.items()}
        self.device = device
        self._bind()
        return self


def stack_chunks(model) -> List[Tuple[str, int, int]]:
    """(stack, start, stop) of every chunk of an HYVideoDiT, in forward
    order."""
    cfg = model.cfg
    sta = cfg.attn_mode.startswith("sta")
    return ([("double_blocks", a, b) for a, b in chunk_plan(
                cfg.mm_double_blocks_depth, cfg.sta_dense_double_blocks,
                sta)]
            + [("single_blocks", a, b) for a, b in chunk_plan(
                cfg.mm_single_blocks_depth, cfg.sta_dense_single_blocks,
                sta)])


@torch.no_grad()
def shard_dit(model, comm, device=None):
    """`model`'s block stacks in place: cut into chunks and shards over
    `comm`, the full tensors freed a chunk at a time; the shards and the
    transient buffers on `device` (default: where the model is)."""
    device = device or model.img_in.proj.weight.device
    shards = WeightShards(comm, device)
    for stack, a, b in stack_chunks(model):
        shards.add_chunk(stack, a, list(getattr(model, stack))[a:b])
    model.weight_shards = shards.finish()
    return model


@torch.no_grad()
def build_sharded_dit(cfg, comm, device, dtype=torch.bfloat16,
                      generator: Optional[torch.Generator] = None,
                      state_dict: Optional[dict] = None, fp8: bool = False,
                      int8: bool = False, int4_modulation: bool = False,
                      modulation_seed: Optional[int] = None):
    """This rank's HYVideoDiT with its stacks weight-sharded over `comm`,
    built on `device` one top-level module, and one chunk of blocks, at a
    time: weights from `state_dict` (on the host) or random from
    `generator` (HYVideoDiT.init_weights's draws in its order), then the
    weight tiers (ops/quantization.quantize_stack), then, with
    `modulation_seed`, utils/seeded.randomize_modulation's draws; a chunk
    is then cut (WeightShards.add_chunk). The values equal those of the
    replicated build (build_dit, quantize_dit, randomize_modulation)."""
    from ..models.dit import HYVideoDiT, init_module
    from ..ops.quantization import quantize_stack
    from ..utils.seeded import randomize_module

    with torch.device("meta"):
        model = HYVideoDiT(cfg, dtype=dtype)
    model.eval().requires_grad_(False)
    rand = (None if modulation_seed is None else
            torch.Generator(device).manual_seed(modulation_seed))
    shards = WeightShards(comm, device)
    plans = {stack: [(a, b) for s_, a, b in stack_chunks(model)
                     if s_ == stack] for stack in STACKS}

    def fill(mod, prefix, stack=False):
        mod.to_empty(device=device)
        if state_dict is not None:
            pre = prefix + "."
            mod.load_state_dict({k[len(pre):]: v for k, v in
                                 state_dict.items() if k.startswith(pre)})
        elif generator is not None:
            for name, m in mod.named_modules(prefix=prefix):
                init_module(name, m, generator)
        if stack:
            quantize_stack(mod, fp8, int8, int4_modulation)
        if rand is not None:
            for name, m in mod.named_modules(prefix=prefix):
                randomize_module(name, m, rand)

    for name, child in list(model.named_children()):
        if name not in STACKS:
            fill(child, name)
            continue
        for a, b in plans[name]:
            blocks = list(child)[a:b]
            for i, blk in enumerate(blocks, start=a):
                fill(blk, f"{name}.{i}", stack=True)
            shards.add_chunk(name, a, blocks)
    model.weight_shards = shards.finish()
    return model


def place_dit(model, device) -> None:
    """model.to(device) for a weight-sharded DiT: the replicated modules
    and the shards move, the block views are bound anew (moving the blocks
    themselves would copy every view of the shared transient buffer)."""
    shards = model.weight_shards
    if shards is None:
        model.to(device)
        return
    for name, child in model.named_children():
        if name not in STACKS:
            child.to(device)
    shards.to(device)
