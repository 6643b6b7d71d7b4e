"""Where a benchmark cell's glue and idle time go, by the port's spans.

    python3 scripts/torch_span_split.py --workload <cell> --seed <n> \
        --seconds <s> [--host-ops]

Runs one traced run of a cell of BENCHMARK.json through
benchmark/run.py:execute (the cell's traffic, its metrics; needs CUDA)
and prints:

- every span of the program (utils/profiling.py:span) in the window: its
  count and its device ms and self device ms a step or round trip;
- the device's idle gaps in the window, each placed by the host's state at
  its midpoint: the profiler's own buffer flushes (the host in
  Activity Buffer Request), else the outermost span open then (`step`,
  `text_encode`, `vae.encoder`, `vae.decoder`, `score.*`), else none (the
  benchmark's own synchronizations and its code between the program's
  calls); ms a step or round trip;
- the frozen `category()`'s glue ("other") kernels by the innermost span
  open when each was launched, and those outside every glue span
  (`dit.*`, `vae.pad`, `vae.norm_act`, the attention wrappers) by the
  operator that launched them, ms a step (all the traced steps) or round
  trip.

The operators' names need --host-ops, which has the profiler record the
host's operators too; they slow the host (a VAE round trip fourfold), so
the idle split of such a run is not the cell's, while the kernels' times
are. The last line of standard output is the result as JSON.
"""
import argparse
import json
import os
import sys
from pathlib import Path

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # as benchmark/run.py: the tokenizer stand-in's `hash` unsalted
    os.environ["PYTHONHASHSEED"] = "0"
    os.execv(sys.executable, [sys.executable] + sys.argv)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

GLUE_SPANS = ("dit.adaln", "dit.qk_rope", "dit.attention", "vae.pad",
              "vae.norm_act")


def capture(host_ops: bool):
    """Patch the benchmark so that the run's state and the raw profiler are
    kept; with host_ops the profiler records the host's operators too."""
    from benchmark import run as bench_run
    from benchmark import trace as bench_trace

    kept = {}
    orig_span = bench_run.Run.per_layer_span

    def per_layer_span(self, *a, **kw):
        kept["run"] = self
        return orig_span(self, *a, **kw)

    bench_run.Run.per_layer_span = per_layer_span
    orig_from = bench_trace.Trace.from_profiler.__func__

    def from_profiler(cls, prof):
        kept["prof"] = prof
        return orig_from(cls, prof)

    bench_trace.Trace.from_profiler = classmethod(from_profiler)
    if host_ops:
        from torch.profiler import ProfilerActivity, profile

        def enter(self):
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            return self

        bench_trace.Recorder.__enter__ = enter
    return kept


def span_table(prof_mod, span, units):
    out = {}
    for r in prof_mod.spans(span["t0"], span["t1"]):
        row = out.setdefault(r.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += r.device_ms / units
        row[2] += r.self_device_ms / units
    return {k: {"count": n, "device_ms": d, "self_device_ms": s}
            for k, (n, d, s) in sorted(out.items())}


def idle_split(run, prof_mod, units):
    from benchmark.spans import TRACER, in_host_op

    tracer = in_host_op(run.trace, TRACER)
    span = run.span
    out = {}
    for s, e in run.trace.busy_and_gaps(span["t0"], span["t1"])[1]:
        mid = s + (e - s) // 2
        if tracer(mid):
            key = "tracer flush"
        else:
            r, key = prof_mod.span_at(mid), "none"
            while r is not None:
                key, r = r.name, r.parent
        out[key] = out.get(key, 0.0) + (e - s) / 1e6 / units
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def glue_split(prof, prof_mod, unit_spans):
    """Glue kernels' device ms by the innermost glue span open on the host
    at their launch (CUPTI ties each kernel to its launching runtime call),
    and those outside every glue span by launching operator (recorded only
    with host operators), inside the spans `unit_spans` and over the count
    of the first of them."""
    from benchmark.yardstick import GLUE, category

    events = list(prof.profiler.kineto_results.events())
    launch, op = {}, {}
    for e in events:
        if str(e.device_type()).endswith("CUDA"):
            continue
        if e.name().startswith("cu"):
            launch[e.correlation_id()] = e.start_ns()
        else:
            op[e.correlation_id()] = e.name()
    units = len(prof_mod.spans(0, 2 ** 63 - 1, unit_spans[0]))
    by_span, rest, unmatched = {}, {}, 0
    for e in events:
        if not str(e.device_type()).endswith("CUDA") \
                or e.is_user_annotation() or category(e.name()) != GLUE:
            continue
        t = launch.get(e.correlation_id())
        if t is None:
            unmatched += 1
            continue
        inner, in_unit, r = None, False, prof_mod.span_at(t)
        while r is not None:
            if inner is None and (r.name in GLUE_SPANS
                                  or r.name.startswith(("flash_", "sta_"))):
                inner = r.name
            in_unit |= r.name in unit_spans
            r = r.parent
        if not in_unit:
            continue
        ms = e.duration_ns() / 1e6 / units
        key = inner or "outside the glue spans"
        by_span[key] = by_span.get(key, 0.0) + ms
        if inner is None:
            name = op.get(e.linked_correlation_id(), "?")
            rest[name] = rest.get(name, 0.0) + ms
    top = sorted(rest.items(), key=lambda kv: -kv[1])[:12]
    return (units, unmatched,
            dict(sorted(by_span.items(), key=lambda kv: -kv[1])), top)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--host-ops", action="store_true")
    a = ap.parse_args()

    from benchmark import run as bench_run

    bench_run.cache_env(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib
    from hunyuanvideo_efficiency_tpu_torch.utils import profiling

    cuda_lib.build()
    torch.cuda.set_device(0)
    kept = capture(a.host_ops)
    bench, w, cfg, traffic = bench_run.cell(a.workload)
    result = bench_run.execute(bench, w, cfg, traffic, a.seed, a.seconds,
                               True, torch.device("cuda", 0))
    run = kept["run"]
    units = run.span["units"]
    torch.cuda.synchronize()
    out = {"workload": a.workload, "seed": a.seed, "units": units,
           "device": torch.cuda.get_device_name(0),
           "metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "spans": span_table(profiling, run.span, units),
           "idle_ms": idle_split(run, profiling, units)}
    n, unmatched, by_span, top = glue_split(
        kept["prof"], profiling, ("step",) if traffic["driver"] == "t2v"
        else ("vae.encoder", "vae.decoder"))
    out.update(glue_units=n, glue_unmatched=unmatched,
               glue_ms_by_span=by_span, glue_outside_spans_by_op=top)
    for k, v in out.items():
        print(f"{k}: {json.dumps(v, indent=1) if isinstance(v, dict) else v}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
