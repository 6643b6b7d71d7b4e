"""On the card: each cell once, short, `correct` true with its end-to-end
metrics, and each cell's control above its limit. Marked `cuda`; skips
without a card (decided inside the test). Run on the GPU host with
`python3 -m pytest benchmark/tests/test_bench_card.py -q`."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "2718281828", "--seconds", "12",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(card, cell):
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json")
                        .read_text())
    r = subprocess.run([sys.executable, "benchmark/control.py",
                        "--workload", cell, "--seconds", "8", "--control",
                        "1414213562"], cwd=ROOT, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])["checks"]
    assert any(v > limits[k]["limit"] for k, v in got.items()), got
