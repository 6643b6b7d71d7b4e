"""Sequence-parallel training helpers over torch.distributed (JAX
counterpart: the shard_map steps of training.py, :43 and :97).

JAX runs one step under shard_map: parameters replicated, the batch
sharded on dp and the flat patch tokens on ulysses x ring, gradients and
loss `lax.pmean`ed over every axis. Here each rank holds the whole model
and calls the step on the same global inputs; `local_inputs` keeps its dp
rows and its ring-major token block (with the RoPE rows of the same
tokens), the text whole; after the backward `average_grads` takes the
world mean of every gradient, so the update that follows is the same on
every rank and the parameters stay equal bit for bit.

The world is the default group: dp x ulysses x ring spans it
(`make_groups` checks that).
"""
from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

from .mesh import SPGroups, check_backend
from .sp_dit import from_rank0

BUCKET_ELEMS = 1 << 26     # fp32 elements a gradient bucket (256 MiB)


def local_inputs(g: SPGroups, x0, noise, t, pe, mask, pe2, f_cos, f_sin):
    """This rank's part of one global batch: token-form x0 and noise
    [B, L, C] to their dp rows and token block, t / pe / mask / pe2 to the
    dp rows, the flat RoPE tables [L, D] to the token block."""
    rows = g.batch_range(x0.shape[0])
    toks = g.token_range(x0.shape[1])
    return (x0[rows, toks], noise[rows, toks], t[rows], pe[rows],
            mask[rows], pe2[rows], f_cos[toks], f_sin[toks])


def world_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over every rank of a tensor (the loss)."""
    x = x.detach().float().clone()
    check_backend(None, x)
    dist.all_reduce(x)
    return x / dist.get_world_size()


def average_grads(params: Iterable[torch.Tensor],
                  bucket_elems: int = BUCKET_ELEMS) -> None:
    """Replaces every parameter's .grad by its world mean (JAX's
    `lax.pmean(grads, axes)`): the gradients, in parameter order, are
    packed into fp32 flat buckets of at most `bucket_elems` elements, one
    all_reduce a bucket, and written back in each gradient's dtype. A
    parameter without a gradient counts as zeros (and gets one), so every
    rank sends the same buckets."""
    params = list(params)
    world = dist.get_world_size()
    i = 0
    while i < len(params):
        n, j = 0, i
        while j < len(params) and (j == i or n + params[j].numel()
                                   <= bucket_elems):
            n += params[j].numel()
            j += 1
        group = params[i:j]
        flat = torch.cat([(p.grad.float() if p.grad is not None
                           else torch.zeros_like(p, dtype=torch.float32))
                          .reshape(-1) for p in group])
        check_backend(None, flat)
        dist.all_reduce(flat)
        flat /= world
        off = 0
        for p in group:
            mean = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            if p.grad is None:
                p.grad = mean.to(p.dtype)
            else:
                p.grad.copy_(mean)
        i = j


@torch.no_grad()
def broadcast_params(model: torch.nn.Module) -> None:
    """Global rank 0's parameters and buffers on every rank, once after the
    init or the load (each rank may have drawn or read its own)."""
    for t in list(model.parameters()) + list(model.buffers()):
        t.data.copy_(from_rank0(t.data))
