"""The program's spans as the per-layer readers take them.

The port names its own ranges (hunyuanvideo_efficiency_tpu_torch/utils/
profiling.py: `span`, recorded while a profiler records, so in a traced
run's window): `spans(t0, t1, name)` gives the records that start in
[t0, t1), each with `device_ms` (start to end on the card, by timing events
on the stream) and `self_device_ms` (less its direct children's), and
`span_at(t)` the innermost span open on the host at t, on the clock of the
trace and of the benchmark's marks (`time.time_ns()`). A checkout whose
program has no span log gives None here, and its readers return None.

Every reader checks the number of its spans against what the cell
implies: the DiT's sites a forward from the configuration's depths, one
forward a step; in the t-ops round trips one encoder and one decoder a
trip, the same count of each span in every trip of one t-ops config, and
one of each score a trip.
"""
from __future__ import annotations

import bisect
import importlib
import itertools
from typing import Callable, Dict, List, Optional, Tuple

# the profiler's own buffer flushes, a host operation of the trace (the
# ledger's breakdown writes it with underscores): the idle readers leave
# out the gaps spent in it
TRACER = "Activity Buffer Request"
SCORES = ("score.psnr", "score.ssim", "score.lpips")


def program():
    """The program's profiling module with its span log, or None."""
    try:
        mod = importlib.import_module(
            "hunyuanvideo_efficiency_tpu_torch.utils.profiling")
    except ImportError:
        return None
    if not hasattr(mod, "spans") or not hasattr(mod, "span_at"):
        return None
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return mod


def dit_sites(cfg: dict) -> Dict[str, int]:
    """Spans of one DiT forward (models/dit.py): 8 adaLN sites a double
    block, 2 a single block, 1 in the final layer; one QK-norm + RoPE and
    one joint attention a block."""
    d = cfg["dit"]
    nd, ns = d["mm_double_blocks_depth"], d["mm_single_blocks_depth"]
    return {"dit.adaln": 8 * nd + 2 * ns + 1, "dit.qk_rope": nd + ns,
            "dit.attention": nd + ns}


def step_total(run, metric: str, name: str, field: str = "device_ms"
               ) -> Optional[float]:
    """ms a step of `field` summed over the `name` spans of the traced
    steps (the t2v window from mark 0 to its last mark); each step must
    hold one forward's count of them."""
    span = run.span
    if not span or span["units"] < 1 or run.trace is None:
        return None
    prof = program()
    if prof is None:
        return None
    t0, t1 = span["t0"], span["t1"]
    steps = prof.spans(t0, t1, "step")
    if len(steps) != span["units"]:
        raise RuntimeError(f"{metric}: {len(steps)} step spans in the "
                           f"window, {span['units']} steps marked")
    recs = prof.spans(t0, t1, name)
    want = dit_sites(run.cfg)[name]
    starts = [r.start_ns for r in recs]
    for s in steps:
        n = (bisect.bisect_left(starts, s.end_ns)
             - bisect.bisect_left(starts, s.start_ns))
        if n != want:
            raise RuntimeError(f"{metric}: {n} {name} spans in a step, "
                               f"{want} a forward of the configuration")
    if len(recs) != want * len(steps):
        raise RuntimeError(f"{metric}: {len(recs)} {name} spans in the "
                           f"window, {want * len(steps)} inside its steps")
    return sum(getattr(r, field) for r in recs) / len(steps)


def score_parts(span) -> List[Tuple[int, int]]:
    """Each traced round trip's scores: from its synchronized
    reconstruction to its end (the next trip's start, the last one's the
    window's end)."""
    parts = span["vae_parts"]
    ends = [a for a, _ in parts[1:]] + [span["t1"]]
    return [(b, e) for (_, b), e in zip(parts, ends)]


def trips_checked(run, metric: str, prof) -> None:
    """One vae.encoder and one vae.decoder in each VAE part, the same count
    of every vae.* span in each trip of one t-ops config, and one of each
    score in each trip's scores."""
    counts: Dict[str, Dict[str, int]] = {}
    for (a, b), name in zip(run.span["vae_parts"], run.shapes["trips"]):
        got: Dict[str, int] = {}
        for r in prof.spans(a, b):
            if r.name.startswith("vae."):
                got[r.name] = got.get(r.name, 0) + 1
        if got.get("vae.encoder") != 1 or got.get("vae.decoder") != 1:
            raise RuntimeError(f"{metric}: a round trip of {name} holds "
                               f"{got.get('vae.encoder', 0)} encoder and "
                               f"{got.get('vae.decoder', 0)} decoder spans")
        if counts.setdefault(name, got) != got:
            raise RuntimeError(f"{metric}: the round trips of {name} hold "
                               f"{counts[name]} and {got} spans")
    for a, b in score_parts(run.span):
        got = sorted(r.name for r in prof.spans(a, b)
                     if r.name.startswith("score."))
        if got != sorted(SCORES):
            raise RuntimeError(f"{metric}: a round trip's scores hold "
                               f"{got}, not one each of {SCORES}")


def trip_total(run, metric: str, name: str) -> Optional[float]:
    """Device ms a round trip of the `name` spans in the traced round
    trips' VAE parts."""
    span = run.span
    if not span or span["units"] < 1 or run.trace is None \
            or "trips" not in run.shapes:
        return None
    prof = program()
    if prof is None:
        return None
    trips_checked(run, metric, prof)
    recs = [r for a, b in span["vae_parts"] for r in prof.spans(a, b, name)]
    if not recs:
        raise RuntimeError(f"{metric}: no {name} span in the round trips")
    return sum(r.device_ms for r in recs) / span["units"]


def in_host_op(trace, name: str) -> Callable[[int], bool]:
    """t -> whether the host operation in flight at t, as
    `trace.host_op_at(t)` names it (the latest started one not yet ended),
    is `name`; indexed once for many calls."""
    ops = trace.host_ops
    starts = [s for _, s, _ in ops]
    reach = list(itertools.accumulate((e for _, _, e in ops), max))

    def at(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and reach[i] >= t:
            if ops[i][2] >= t:
                return ops[i][0] == name
            i -= 1
        return False

    return at


def idle_ms(run, metric: str, parts, inside: Callable[[str], bool]
            ) -> Optional[float]:
    """ms a round trip of the device's idle gaps in `parts` whose midpoint
    the host spent inside a span whose name (or an enclosing one's)
    `inside` accepts; gaps in the profiler's own buffer flushes are left
    out."""
    span = run.span
    if not span or span["units"] < 1 or run.trace is None \
            or "trips" not in run.shapes:
        return None
    prof = program()
    if prof is None:
        return None
    trips_checked(run, metric, prof)
    tracer = in_host_op(run.trace, TRACER)
    total = 0
    for a, b in parts:
        for s, e in run.trace.busy_and_gaps(a, b)[1]:
            mid = s + (e - s) // 2
            r = prof.span_at(mid)
            while r is not None and not inside(r.name):
                r = r.parent
            if r is not None and not tracer(mid):
                total += e - s
    return total / 1e6 / span["units"]
