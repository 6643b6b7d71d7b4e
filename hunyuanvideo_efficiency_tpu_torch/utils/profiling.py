"""Profiling hooks (JAX counterpart: utils/profiling.py; the reference has
only wall-clock logging, hyvideo/inference.py:645-669).

`maybe_trace(profile_dir)` records a torch.profiler trace (CPU, and CUDA
where a card is present) and writes it under `profile_dir` as a chrome
trace (`--profile-dir`, viewable in Perfetto or chrome://tracing);
`PhaseTimer` accumulates named wall-clock phases; `span(name)` is a named
range of the program, and costs nothing when no profiler runs;
`device_ms_by_category(fn)` splits one call's device time on the card.

Spans. While a torch.profiler records (any activity), `span(name)` enters
a `torch.profiler.record_function` range, so that chrome traces show it,
and appends a `SpanRecord` to an in-memory log: its name, its parent (the
innermost span open on the same thread), host start and end in
`time.time_ns()` (the clock of the profiler's own timestamps) and, where
CUDA is initialized, a pair of timing events recorded on the current
stream, taken from a reused pool. Readers synchronize the device, then
call `spans(t0, t1)` for the records that start in [t0, t1), each with
`device_ms` (event to event on the card; host time without CUDA) and
`self_device_ms` (that less its direct children's), and `span_at(t)` for
the innermost span open on the host at t. The log keeps the newest
`SPAN_LOG_LIMIT` records (32,768: a 30 s traced window of the 540p step
makes ~6,500, a 50-step 540p predict under `--profile-dir` ~27,000); older
ones are dropped and their events return to the pool. With no profiler
recording, `span` returns one shared no-op context: no allocation, no
record, no synchronization.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import os
import threading
import time
from typing import Deque, Dict, Iterator, List, Optional

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
        # a named range (`span`) also spans its kernels on the device
        # timeline; counting it too would count them twice
        if (e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                and not getattr(e, "is_user_annotation", False)):
            c = kernel_category(e.key)
            cats[c] = cats.get(c, 0.0) + e.self_device_time_total / 1e3
    if not cats:
        raise RuntimeError("the profiler recorded no device time")
    return cats


SPAN_LOG_LIMIT = 1 << 15

_OFF = contextlib.nullcontext()
_log: Deque["SpanRecord"] = collections.deque()
_events: List[torch.cuda.Event] = []
_open = threading.local()
_by_start: list = [None]    # the log sorted by start, and its starts


class SpanRecord:
    """One span: `name`, `parent` (a SpanRecord or None), host `start_ns`
    and `end_ns`; `device_ms` and `self_device_ms` once `spans` read it."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "events",
                 "device_ms", "self_device_ms")

    def __init__(self, name: str):
        self.name = name
        self.events = None
        self.device_ms = self.self_device_ms = None


def _event() -> torch.cuda.Event:
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str):
        self.rec = SpanRecord(name)
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        rec = self.rec
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        rec.parent = stack[-1] if stack else None
        stack.append(rec)
        rec.start_ns = time.time_ns()
        if torch.cuda.is_initialized():
            rec.events = (_event(), _event())
            rec.events[0].record()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        if rec.events is not None:
            rec.events[1].record()
        rec.end_ns = time.time_ns()
        _open.stack.pop()
        if len(_log) >= SPAN_LOG_LIMIT:
            old = _log.popleft()
            if old.events is not None:
                _events.extend(old.events)
        _log.append(rec)
        _by_start[0] = None
        self.rf.__exit__(*exc)
        return False


def span(name: str):
    """A named range of the program (see the module docstring): recorded
    while a profiler records, else a shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def _device_ms(rec: SpanRecord) -> float:
    if rec.events is None:
        return (rec.end_ns - rec.start_ns) / 1e6
    return rec.events[0].elapsed_time(rec.events[1])


def spans(t0_ns: int, t1_ns: int, name: Optional[str] = None
          ) -> List[SpanRecord]:
    """The logged spans (of `name`, or all) whose host start lies in
    [t0_ns, t1_ns), in start order, with `device_ms` and `self_device_ms`
    filled in. The caller has synchronized the device."""
    recs = list(_log)
    out = [r for r in recs if t0_ns <= r.start_ns < t1_ns
           and (name is None or r.name == name)]
    child: Dict[int, float] = {id(r): 0.0 for r in out}
    for r in recs:
        if r.parent is not None and id(r.parent) in child:
            child[id(r.parent)] += _device_ms(r)
    for r in out:
        r.device_ms = _device_ms(r)
        r.self_device_ms = r.device_ms - child[id(r)]
    out.sort(key=lambda r: r.start_ns)
    return out


def span_at(t_ns: int) -> Optional[SpanRecord]:
    """The innermost logged span open on the host at t_ns, or None. Spans
    nest on one thread: the innermost open one is the latest started one
    not yet ended, and none started before a closed outermost span is
    open after it, so the search stops there."""
    if _by_start[0] is None:
        recs = sorted(_log, key=lambda r: r.start_ns)
        _by_start[0] = (recs, [r.start_ns for r in recs])
    recs, starts = _by_start[0]
    for i in range(bisect.bisect_right(starts, t_ns) - 1, -1, -1):
        if recs[i].end_ns > t_ns:
            return recs[i]
        if recs[i].parent is None:
            return None
    return None


def clear_spans() -> None:
    """Empty the span log (its events return to the pool)."""
    while _log:
        old = _log.popleft()
        if old.events is not None:
            _events.extend(old.events)
    _by_start[0] = None
