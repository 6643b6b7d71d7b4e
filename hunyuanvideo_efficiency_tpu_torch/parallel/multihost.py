"""Process-group start-up under torchrun (JAX counterpart:
parallel/multihost.py; reference: hyvideo/inference.py:156-181,
scripts/run_sample_video_multigpu.sh).

JAX starts one process per host and sees every chip through one mesh; the
reference and this port start one process per GPU under torchrun, which
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT. On CUDA
devices the group is NCCL and each rank takes `cuda:LOCAL_RANK`; gloo is
used only when the caller asked for the CPU (`--device cpu`). There is no
CPU fallback for a CUDA run.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize_multihost(device: str = "cuda", timeout=None) -> str:
    """Starts the default process group from torchrun's environment when
    WORLD_SIZE > 1 (no-op otherwise, or when a group already exists) and
    returns the device this rank computes on: `cuda:LOCAL_RANK` for a CUDA
    run, `device` unchanged otherwise. `timeout` (a timedelta) bounds how
    long a collective may wait for its peers (the backend's default
    otherwise)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    cuda = torch.device(device).type == "cuda"
    if world <= 1 and not dist.is_initialized():
        return device
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA run under torchrun needs a CUDA device "
                               "on every rank; pass --device cpu for gloo")
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    if not dist.is_initialized():
        dist.init_process_group(backend="nccl" if cuda else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=world, timeout=timeout)
    return device


def is_primary() -> bool:
    """True on the rank that writes outputs (the reference saves the mp4
    on rank 0 only, sample_video.py:49)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a batch split over every rank by GLOBAL rank: JAX's
    per-process slice (JAX parallel/multihost.py:54-59), where a process
    is a host that feeds all of its chips. It is not a data-parallel
    loader's slice here: under ulysses x ring the sp ranks of one dp shard
    must see the same rows, which `SPGroups.batch_range` (by dp index)
    gives and this does not."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = global_batch // n
    return slice(i * per, (i + 1) * per)
