"""What the benchmark may import, compared by whole top-level module
names: nothing in benchmark/ imports jax, jaxlib, flax or the JAX package
(the port's name begins with the JAX package's, so a prefix match would be
wrong), and the plain reference imports nothing of the port. The runner
without a card, or without the program beside it, prints no result."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "hunyuanvideo_efficiency_tpu"}
PORT = "hunyuanvideo_efficiency_tpu_torch"


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def py_files(root: Path):
    return sorted(p for p in root.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", py_files(BENCH),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & JAX


def test_whole_names_are_compared():
    assert PORT.split(".")[0] not in JAX
    assert PORT.startswith("hunyuanvideo_efficiency_tpu")


REFERENCE = py_files(BENCH / "reference") + [
    BENCH / "weights.py", BENCH / "traffic.py", BENCH / "yardstick.py",
    BENCH / "work.py"]


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_port(path):
    mods = set(top_level_imports(path))
    assert PORT not in mods and not mods & JAX


def test_reference_modules_load_without_the_port():
    code = ("import sys; import benchmark.reference.dit, "
            "benchmark.reference.text, benchmark.reference.vae, "
            "benchmark.reference.scores; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(JAX | {PORT})!r}]; print(bad); assert not bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_runner_without_a_card_prints_no_result():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "t2v-dense-540p65", "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_runner_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "vae-tops-240p65", "--seed", "7", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""
