"""Runs one cell of the benchmark once and prints its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from BENCHMARK.json: the cell's configuration
(benchmark/configs/<config>.json), its traffic (benchmark/traffic/
<traffic>.json, whose `driver` names benchmark/drivers/<driver>.py), its
per-layer metrics (benchmark/metrics/<metric>.py, each a `read(run)`,
with the program's kernel wrappers whose launch counters it reads in
`COUNTERS`) and the limits of its checks (benchmark/limits/<workload>.json). With
`--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a torch.profiler trace of the
window kept in memory. The last line of standard output is the JSON
result; the numbers compared and their limits close standard error.

Needs CUDA: without a card, or with fewer cards than the cell asks for, it
exits 2 and prints no result. The program is the PyTorch port beside this
directory; nothing here imports JAX or the JAX package, and the run ends
with an error if either was loaded.
"""
from __future__ import annotations

import os
import sys
import time

T_START = float(os.environ.get("HV_BENCH_T0", time.time()))

if __name__ == "__main__" and os.environ.get("PYTHONHASHSEED") != "0":
    # the tokenizer stand-in hashes words with `hash`: fix its salt so that
    # a seed gives the same token ids in every run
    os.environ.update(PYTHONHASHSEED="0", HV_BENCH_T0=repr(T_START))
    os.execv(sys.executable, [sys.executable] + sys.argv)

import argparse  # noqa: E402
import functools  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "hunyuanvideo_efficiency_tpu")


def cache_env(root: Path) -> None:
    """Every build and kernel cache in fixed directories of the
    checkout."""
    os.environ.setdefault("HVTORCH_BUILD_DIR", str(root / "build" / "cuda"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(root / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """(workload entry, configuration dict, traffic dict) of a cell."""
    bench = json.loads(bench_path.read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == workload]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    cfg = json.loads((ROOT / c["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return bench, w, cfg, traffic


class Run:
    """One run's state: filled by the driver, read by the metric readers."""

    def __init__(self, name, cfg, traffic, seed, seconds, trace, device):
        self.name, self.cfg, self.traffic = name, cfg, traffic
        self.seed, self.seconds, self.tracing = seed, seconds, trace
        self.device = device
        self.e2e = {}
        self.checks = {}
        self.attempted = self.failed = 0
        self.trace = None
        self.span = None
        self.shapes = {}
        self._rec = None
        self.marks = []
        self.peak_bytes = 0
        self.metrics = []            # the cell's per-layer metric names

    # hooks for the driver
    def log(self, what: str):
        print(f"[bench] {time.time() - T_START:9.3f} s  {what}",
              file=sys.stderr, flush=True)

    def setup_done(self):
        self.e2e["setup_s"] = time.time() - T_START

    def window_start(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def window_end(self):
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            self.peak_bytes = torch.cuda.max_memory_allocated()
            self.e2e["peak_gib"] = self.peak_bytes / 2 ** 30

    def recorder(self):
        from benchmark.trace import Recorder

        self._rec = Recorder(self.tracing)
        return self._rec

    def mark(self):
        """A mark in the trace's clock, at a point the caller has
        synchronized (the window's start, each step's or round trip's
        end)."""
        self.marks.append(time.time_ns())

    def read_counts(self):
        """{wrapper: its LAUNCHES so far} of every kernel wrapper that the
        cell's per-layer metrics name in their COUNTERS
        ({wrapper: "module:attribute"} of the program)."""
        out = {}
        for name in self.metrics:
            for key, where in getattr(metric_module(name), "COUNTERS",
                                      {}).items():
                mod, attr = where.split(":")
                out[key] = getattr(importlib.import_module(mod),
                                   attr).LAUNCHES
        return out

    def per_layer_span(self, first_mark, last_mark, units, launches,
                       **extra):
        """The traced interval the per-layer metrics read: from mark
        `first_mark` to mark `last_mark`, holding `units` steps or round
        trips and `launches` of the counted kernel wrappers; `extra` keys
        are the driver's (intervals inside it, host times)."""
        self.trace = self._rec.trace if self._rec is not None else None
        if self.trace is None:
            return
        self.span = dict(t0=self.marks[first_mark], t1=self.marks[last_mark],
                         units=units, launches=launches, **extra)


@functools.lru_cache(maxsize=None)
def metric_module(name: str):
    return load_module(HERE / "metrics" / f"{name}.py",
                       f"benchmark.metrics.{name.replace('.', '_')}")


def read_metric(name: str, run: Run):
    return metric_module(name).read(run)


def limits(workload: str) -> dict:
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_env(ROOT)

    import torch

    bench, w, cfg, traffic = cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"needs {w['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib

    cuda_lib.build()                      # a no-op once the checkout built
    torch.cuda.set_device(0)
    result = execute(bench, w, cfg, traffic, a.seed, a.seconds,
                     bool(a.trace), torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the benchmark measures the "
              f"PyTorch port only", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def execute(bench, w, cfg, traffic, seed, seconds, trace, device,
            lim=None) -> dict:
    """One run of the cell `w` on `device` (its driver, its metrics, its
    checks against their limits, `lim` or the cell's file): the result
    line as a dict."""
    import torch

    run = Run(w["name"], cfg, traffic, seed, seconds, trace, device)
    run.metrics = [m["name"] for m in bench["per_layer"]
                   if w["name"] in m.get("workloads", [w["name"]])]
    importlib.import_module(f"benchmark.drivers.{traffic['driver']}").run(run)
    kind = torch.cuda.get_device_name(0) if run.device.type == "cuda" \
        else "cpu"
    result = {"correct": None, "attempted": run.attempted,
              "failed": run.failed, "metrics": {},
              "device": {"platform": "gpu" if kind != "cpu" else "cpu",
                         "kind": kind, "count": w["chips"],
                         "memory_peak_bytes": run.peak_bytes}}
    if trace:
        span = run.span
        busy, _ = run.trace.busy_and_gaps(span["t0"], span["t1"])
        result["device"].update(busy_s=busy,
                                window_s=(span["t1"] - span["t0"]) / 1e9)
        for m in bench["per_layer"]:
            if m["name"] in run.metrics:
                v = read_metric(m["name"], run)
                if v is not None:
                    result["metrics"][m["name"]] = {"value": v,
                                                    "unit": m["unit"]}
        result["breakdown"] = run.trace.breakdown(span["t0"], span["t1"])
    else:
        for m in bench["end_to_end"]:
            if w["name"] in m.get("workloads", [w["name"]]):
                result["metrics"][m["name"]] = {"value": run.e2e[m["name"]],
                                                "unit": m["unit"]}
    lim = limits(w["name"]) if lim is None else lim
    checks = {k: {"value": v, "limit": lim.get(k, {}).get("limit")}
              for k, v in run.checks.items()}
    result["correct"] = bool(checks) and all(
        c["limit"] is not None and math.isfinite(c["value"])
        and c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


if __name__ == "__main__":
    sys.exit(main())
