"""The traced run's device trace, kept in memory, and its reduction.

`Recorder` runs torch.profiler over the measured window with CUDA
activity only: the device's operations (kernels, copies, sets) and the
host's CUDA runtime calls, without the per-operator host events, whose
recording slowed a VAE round trip fourfold and idled the card. `Trace`
holds them from the profiler's raw events and reduces them: device busy
time (the union of the operations' intervals) and idle gaps over an
interval, device seconds by kernel name and by the frozen `category()`,
and the longest idle gaps labelled by the runtime call the host was in
(or had last made). Intervals are bounded by the benchmark's own marks,
`time.time_ns()` at synchronized points, the clock of the trace's
timestamps.
"""
from __future__ import annotations

import bisect
import re
from typing import Dict, List, Optional, Tuple

import torch

from .yardstick import category

def short(name: str, n: int = 90) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    return name.split("(")[0][:n]


class Trace:
    def __init__(self, device_ops, host_ops):
        """device_ops: [(name, start_ns, end_ns)] sorted by start;
        host_ops: [(name, start_ns, end_ns)] sorted by start."""
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.starts = [s for _, s, _ in device_ops]

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        """From the profiler's raw events, whose times are epoch ns (the
        clock of `time.time_ns()`): device operations are the CUDA events
        that are not named ranges, host operations the others."""
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            span = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            if e.is_user_annotation():
                continue
            (dev if str(e.device_type()).endswith("CUDA") else host).append(
                span)
        dev.sort(key=lambda x: x[1])
        host.sort(key=lambda x: x[1])
        return cls(dev, host)

    def ops_in(self, t0: int, t1: int):
        """Device operations that start in [t0, t1)."""
        i, j = (bisect.bisect_left(self.starts, t) for t in (t0, t1))
        return self.device_ops[i:j]

    def busy_and_gaps(self, t0: int, t1: int) -> Tuple[float,
                                                         List[Tuple[int,
                                                                    int]]]:
        """(seconds in which an operation ran, clipped to [t0, t1]; the
        idle gaps [(start, end)])."""
        busy, gaps = 0, []
        cur_s = cur_e = None
        for _, s, e in self.device_ops:
            s, e = max(s, t0), min(e, t1)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                    gaps.append((cur_e, s))
                elif s > t0:
                    gaps.append((t0, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
            if cur_e < t1:
                gaps.append((cur_e, t1))
        else:
            gaps.append((t0, t1))
        return busy / 1e9, gaps

    def seconds_by(self, key, t0: int, t1: int) -> Dict[str, float]:
        """Device seconds of the operations starting in [t0, t1), summed by
        key(name)."""
        out: Dict[str, float] = {}
        for n, s, e in self.ops_in(t0, t1):
            k = key(n)
            out[k] = out.get(k, 0.0) + (e - s) / 1e9
        return out

    def by_category(self, t0: int, t1: int) -> Dict[str, float]:
        return self.seconds_by(category, t0, t1)

    def count(self, pred, t0: int, t1: int) -> int:
        return sum(1 for n, _, _ in self.ops_in(t0, t1) if pred(n))

    def seconds(self, pred, t0: int, t1: int) -> float:
        return sum((e - s) / 1e9 for n, s, e in self.ops_in(t0, t1)
                   if pred(n))

    def host_op_at(self, t: int) -> str:
        """The innermost host operation in flight at t (the latest started
        one that has not ended), else the last one to end before t."""
        best = last = None
        last_end = -1
        hi = bisect.bisect_right([s for _, s, _ in self.host_ops], t)
        for n, s, e in self.host_ops[:hi]:
            if e >= t:
                best = n
            elif e > last_end:
                last, last_end = n, e
        if best is not None:
            return best
        return f"after {last}" if last else "host: no recorded operation"

    def breakdown(self, t0: int, t1: int, n: int = 10) -> dict:
        """The `breakdown` of the result line: the device operations that
        took most time, and the longest idle gaps by what the host was
        doing."""
        ops = sorted(self.seconds_by(short, t0, t1).items(),
                     key=lambda kv: -kv[1])[:n]
        _, gaps = self.busy_and_gaps(t0, t1)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[short(self.host_op_at(s + (e - s) // 2), 80),
                               (e - s) / 1e9] for s, e in gaps]}


class Recorder:
    """torch.profiler over a block, the trace kept in memory."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None
        self.trace: Optional[Trace] = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[
                ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
            if exc[0] is None:
                self.trace = Trace.from_profiler(self.prof)
            self.prof = None
        return False
