"""Profiling hooks (JAX counterpart: utils/profiling.py; the reference has
only wall-clock logging, hyvideo/inference.py:645-669).

`maybe_trace(profile_dir)` records a torch.profiler trace (CPU, and CUDA
where a card is present) and writes it under `profile_dir` as a chrome
trace (`--profile-dir`, viewable in Perfetto or chrome://tracing);
`PhaseTimer` accumulates named wall-clock phases; `annotate(name)` is a
named range in a trace, and costs nothing when no profiler runs;
`device_ms_by_category(fn)` splits one call's device time on the card.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str]) -> Iterator[None]:
    """A torch.profiler trace of the block when a directory is given; the
    chrome trace goes to `profile_dir/trace_rank<R>_<ns>.json`."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    rank = (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0)
    prof.export_chrome_trace(os.path.join(
        profile_dir, f"trace_rank{rank}_{time.time_ns()}.json"))


class PhaseTimer:
    """Accumulates named phase wall-times (text encode / denoise / decode)."""

    def __init__(self):
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}={v:.2f}s" for k, v in self.phases.items()]
        return f"total={total:.2f}s ({', '.join(parts)})"


def kernel_category(name: str) -> str:
    """The part of a sequence-parallel attention call a device kernel
    belongs to: "nccl" (collectives, their waits for the peers included),
    "attention" (the hand-written kernels and their pre-passes),
    "copies_and_cat", or "other" (state merges and other elementwise
    work)."""
    low = name.lower()
    if "nccl" in low:
        return "nccl"
    if any(s in low for s in ("flash_", "sta_", "quantize_groups",
                              "tile_codes")):
        return "attention"
    if any(s in low for s in ("copy", "cat", "memcpy", "memset")):
        return "copies_and_cat"
    return "other"


def device_ms_by_category(fn) -> Dict[str, float]:
    """One call of fn under torch.profiler, the card synchronized after
    it: its device kernels' ms summed by `kernel_category`. Raises when the
    profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cats: Dict[str, float] = {}
    for e in prof.key_averages():
        # a named range (`annotate`) also spans its kernels on the device
        # timeline; counting it too would count them twice
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            c = kernel_category(e.key)
            cats[c] = cats.get(c, 0.0) + e.self_device_time_total / 1e3
    if not cats:
        raise RuntimeError("the profiler recorded no device time")
    return cats


def annotate(name: str):
    """A named range in profiler traces (torch.profiler.record_function);
    a no-op context when no profiler is recording."""
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
