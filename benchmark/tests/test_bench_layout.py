"""BENCHMARK.json against the contract's rules, and every item it names
resolving by name to its file under benchmark/."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
HERE = ROOT / "benchmark"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert LINE.match(word) and not word.startswith("/") \
            and ".." not in word
    assert (ROOT / BENCH["command"][1]).is_file()


def names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for item in BENCH[key]:
            yield key, item


@pytest.mark.parametrize("key,item", list(names()),
                         ids=lambda v: v if isinstance(v, str)
                         else v.get("name"))
def test_names_and_units(key, item):
    assert NAME.match(item["name"])
    if "unit" in item:
        assert UNIT.match(item["unit"])
        assert item["better"] in ("lower", "higher")
    for k in ("why", "layer") + (("source",) if key == "configs" else ()):
        if k in item:
            assert LINE.match(item[k]), (k, item[k])
    for k in ("config", "traffic"):
        if k in item:
            assert NAME.match(item[k])


def test_unique_names_and_entry_keys():
    for key, allowed in (
            ("configs", {"name", "source", "file", "reduced", "why"}),
            ("workloads", {"name", "config", "traffic", "chips", "why"}),
            ("end_to_end", {"name", "unit", "better", "bound", "source",
                            "workloads"}),
            ("per_layer", {"name", "unit", "better", "source", "layer",
                           "moves", "workloads"})):
        items = BENCH[key]
        assert len({i["name"] for i in items}) == len(items)
        for i in items:
            assert set(i) <= allowed, (key, set(i) - allowed)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_resolves(cfg):
    path = ROOT / cfg["file"]
    assert path.is_file() and cfg["file"].startswith("benchmark/")
    data = json.loads(path.read_text())
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert cfg["source"].startswith("https://") and len(cfg["source"]) <= 200
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_resolves(w):
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    assert (HERE / "drivers" / f"{traffic['driver']}.py").is_file()
    assert w["chips"] in (1, 4)
    e2e = [m["name"] for m in BENCH["end_to_end"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    per = [m for m in BENCH["per_layer"]
           if w["name"] in m.get("workloads", [w["name"]])]
    assert per
    for m in per:
        assert m["moves"] in e2e
    limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
    assert all(v["lower"] < v["limit"] < v["upper"]
               for v in limits.values())


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_resolves(m):
    src = (HERE / "metrics" / f"{m['name']}.py").read_text()
    assert "def read(run)" in src
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    for w in m["workloads"]:
        assert w in {x["name"] for x in BENCH["workloads"]}
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    (setup,) = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup["bound"] == 0.25


def test_check_budget():
    """2 + 14 runs a cell of run_seconds + 60 s, 2 x 90 s of compile a
    cell and 1,200 s spare fit 43,200 s with 24 cells."""
    r = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (r + 60) + 24 * 180 + 1200 <= 43200
