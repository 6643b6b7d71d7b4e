"""The PyTorch port stands alone: it never imports JAX or the JAX package,
and a tensor off the CPU reaching a kernel wrapper launches the kernel or
raises; it never falls back to the plain version."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu_torch.ops import cuda_lib
from hunyuanvideo_efficiency_tpu_torch.ops.conv3d_cuda import (
    conv3d_stride1, conv3d_stride1_v2)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_attention import (
    flash_int8_running, flash_int8_static, flash_running, flash_static)
from hunyuanvideo_efficiency_tpu_torch.ops.flash_backward import (
    flash_bwd_dkv, flash_bwd_dq, flash_fwd_lse)
from hunyuanvideo_efficiency_tpu_torch.ops.int8_matmul import w8a8_linear
from hunyuanvideo_efficiency_tpu_torch.ops.sta import (
    sta_direct, sta_direct_int8, sta_permuted_running, sta_permuted_static,
    sta_permuted_static_int8, sta_ring)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "hunyuanvideo_efficiency_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "hunyuanvideo_efficiency_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "scripts").glob("torch_*.py")))
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_quantized_path_modules_are_covered():
    """The modules of the quantized serving path are among the checked
    sources."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("ops/quantization.py", "ops/int8_matmul.py",
                "ops/flash_attention.py", "ops/sta.py", "utils/checkpoint.py",
                "utils/weights.py", "models/text/encoder.py"):
        assert f"hunyuanvideo_efficiency_tpu_torch/{mod}" in names


def test_training_path_modules_are_covered():
    """The modules of the fine-tuning path are among the checked sources."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("ops/flash_backward.py", "training.py", "train.py",
                "utils/train_io.py", "data/dataset_loader.py",
                "parallel/sp_train.py", "parallel/sp_attention.py",
                "parallel/mesh.py", "parallel/multihost.py"):
        assert f"hunyuanvideo_efficiency_tpu_torch/{mod}" in names


def test_probe_modules_are_covered():
    """The entry points that run the ring and temporal-reuse kernels are
    among the checked sources."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("probes/__init__.py", "probes/conv_probe.py",
                "probes/sta_kernel_bench.py"):
        assert f"hunyuanvideo_efficiency_tpu_torch/{mod}" in names


def test_harness_modules_are_covered():
    """The modules of the t-ops experiment harness (the VAE round trip, the
    metric suite, the sweep and their entries) are among the checked
    sources."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("models/vae.py", "models/vae_config.py", "infer.py",
                "compute_metrics.py", "run_experiments.py",
                "dynamic_enumeration.py", "data/mp42tensor.py",
                "data/yuv_tensor.py", "data/video_bit_rate.py",
                "evaluation/__init__.py", "evaluation/metrics.py",
                "evaluation/lpips.py", "evaluation/fvd.py",
                "evaluation/fvmd.py", "evaluation/compute_metrics.py",
                "evaluation/run_metrics.py", "experiments/__init__.py",
                "experiments/enumeration.py", "experiments/runner.py",
                "experiments/analysis.py"):
        assert f"hunyuanvideo_efficiency_tpu_torch/{mod}" in names


def test_serving_and_parallel_modules_are_covered():
    """The modules of sequence-parallel sampling and of the serving entries
    and tools are among the checked sources."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "parallel/multihost.py", "parallel/sp_attention.py",
                "parallel/sp_dit.py", "diffusion/scheduler.py",
                "diffusion/pipeline.py", "serve.py", "gradio_server.py",
                "cli.py", "prompt_rewrite.py", "utils/profiling.py",
                "utils/logging.py", "utils/collect_env.py",
                "sample_video.py"):
        assert f"hunyuanvideo_efficiency_tpu_torch/{mod}" in names


def test_memory_tier_modules_are_covered():
    """The modules of the scale-out memory tiers (the weight-sharded DiT,
    the tensor-parallel Llama tower, the tile-sharded VAE and their
    collectives) are among the checked sources."""
    names = {p.relative_to(ROOT).as_posix() for p in _sources()}
    for mod in ("parallel/comm.py", "parallel/weight_shard.py",
                "models/text/llama.py", "models/text/encoder.py",
                "models/vae.py", "models/dit.py", "inference.py",
                "infer.py", "utils/seeded.py"):
        assert f"hunyuanvideo_efficiency_tpu_torch/{mod}" in names
    assert "scripts/torch_sp_nccl.py" in names


def test_row_parallel_arms_never_fall_back():
    """B9's given-scale and s32 arms on meta tensors raise and count no
    launch."""
    x = torch.empty((3, 128), dtype=torch.bfloat16, device="meta")
    w8 = torch.empty((128, 128), dtype=torch.int8, device="meta")
    so = torch.empty(128, device="meta")
    n0 = w8a8_linear.LAUNCHES
    for kw in (dict(row_scale=torch.empty(3, device="meta")),
               dict(s32=True)):
        with pytest.raises(ValueError, match="CUDA"):
            w8a8_linear(x, w8, so, **kw)
    assert w8a8_linear.LAUNCHES == n0


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import hunyuanvideo_efficiency_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_off_cpu_tensors_never_fall_back():
    """Meta tensors are neither CPU nor CUDA: every wrapper raises and
    counts no launch."""
    q = torch.empty((1, 64, 2, 64), dtype=torch.bfloat16, device="meta")
    c = torch.empty((1, 2), device="meta")
    xp = torch.empty((1, 3, 6, 6, 128), dtype=torch.float16, device="meta")
    w = torch.empty((3, 3, 3, 128, 128), dtype=torch.float16, device="meta")
    kernels = (flash_static, flash_running, conv3d_stride1, sta_direct,
               sta_permuted_static, sta_permuted_running, w8a8_linear,
               flash_int8_static, flash_int8_running, sta_direct_int8,
               sta_permuted_static_int8, flash_fwd_lse, flash_bwd_dq,
               flash_bwd_dkv, sta_ring, conv3d_stride1_v2)
    counts = [fn.LAUNCHES for fn in kernels]
    do = torch.empty((1, 64, 128), dtype=torch.bfloat16, device="meta")
    stat = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd_lse(q, q, q, None, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dq(q, q, q, None, do, stat, stat, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_bwd_dkv(q, q, q, None, do, stat, stat, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_static(q, q, q, None, c, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_running(q, q, q, None, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_stride1(xp, w)
    with pytest.raises(ValueError, match="CUDA"):
        conv3d_stride1_v2(xp, w)
    geom = ((1, 8, 8), (1, 8, 8), (3, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        sta_direct(q, q, q, q, q, None, c, *geom, 0.125)
    kb = torch.empty((1, 64), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sta_permuted_static(q, q, q, kb, c, *geom, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        sta_permuted_running(q, q, q, kb, *geom, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        sta_direct_int8(q, q, q, q, q, None, c, *geom, 0.125)
    q5 = torch.empty((1, 1, 8, 8, 128), dtype=torch.bfloat16, device="meta")
    rows = torch.empty((1, 64, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sta_ring(q5, rows, rows, rows, rows, kb, c, (1, 8, 8), (1, 8, 8),
                 (1, 1, 3), 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        sta_permuted_static_int8(q, q, q, kb, c, *geom, 0.125)
    with pytest.raises(ValueError, match="CUDA"):
        flash_int8_static(q, q, q, None, c, 0.125, 64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        flash_int8_running(q, q, q, None, 0.125, 64, 64)
    x = torch.empty((3, 128), dtype=torch.bfloat16, device="meta")
    w8 = torch.empty((128, 128), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        w8a8_linear(x, w8, torch.empty(128, device="meta"))
    assert counts == [fn.LAUNCHES for fn in kernels]


@pytest.mark.parametrize("grad", [False, True])
def test_qk_norm_rope_off_cpu_never_falls_back(grad):
    """The QK-RMSNorm + RoPE wrapper on meta tensors raises and counts no
    launch, also under grad (its autograd.Function)."""
    from hunyuanvideo_efficiency_tpu_torch.ops.rope import qk_norm_rope

    q = torch.empty((1, 64, 2, 128), dtype=torch.bfloat16, device="meta",
                    requires_grad=grad)
    w = torch.empty(128, dtype=torch.bfloat16, device="meta")
    n0 = qk_norm_rope.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        qk_norm_rope(q, q, w, w, None)
    assert qk_norm_rope.LAUNCHES == n0


def test_missing_library_without_nvcc_raises(monkeypatch, tmp_path):
    """No built library and no CUDA toolkit: loading a kernel raises."""
    from torch.utils import cpp_extension

    monkeypatch.setenv("HVTORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(cuda_lib, "_loaded", {})
    for name in cuda_lib.SIGNATURES:
        assert not cuda_lib.library_path(name).exists()
        with pytest.raises(RuntimeError, match="nvcc"):
            cuda_lib.library(name)


def test_library_path_tracks_sources(monkeypatch, tmp_path):
    """The build is keyed on the sources: one name per kernel source, in
    the build directory, stable across calls."""
    monkeypatch.setenv("HVTORCH_BUILD_DIR", str(tmp_path))
    paths = {n: cuda_lib.library_path(n) for n in cuda_lib.SIGNATURES}
    assert len(set(paths.values())) == len(paths)
    for n, p in paths.items():
        assert p.parent == tmp_path and p.name.startswith(f"lib{n}-")
        assert cuda_lib.library_path(n) == p
        assert (cuda_lib.CSRC / f"{n}.cu").exists()


@pytest.mark.parametrize("name", sorted(cuda_lib.SIGNATURES))
def test_signatures_match_the_sources_exports(name):
    """Each source's `extern "C"` functions are exactly the ones its
    SIGNATURES entry binds, with as many arguments."""
    import re

    text = (cuda_lib.CSRC / f"{name}.cu").read_text()
    exports = {m.group(1): m.group(2) for m in re.finditer(
        r'extern "C" int (\w+)\s*\(([^)]*)\)', text)}
    assert set(exports) == set(cuda_lib.SIGNATURES[name])
    for fn, (_, argtypes) in cuda_lib.SIGNATURES[name].items():
        assert len(exports[fn].split(",")) == len(argtypes), fn
