"""Build and load the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` compiles with nvcc for `sm_90a` into its own shared
library with a plain C interface, loaded with ctypes. Libraries are built
at first use, from the package's sources only, into `build/cuda/` next to
the package (override with HVTORCH_BUILD_DIR); the file name carries a
hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused. `build()` starts one nvcc per missing library,
all at once, and waits for them together.

Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

# name -> C signature: (restype, argtypes)
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "flash_attention": {
        "hv_flash_attention_fwd": (
            _I, [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                 _LL, _LL, _LL, _LL, _LL, _LL, _F, _I, _P, _P]),
        "hv_flash_fwd_lse": (
            _I, [_I] * 2 + [_P] * 6 + [_I] * 4 + [_LL] * 6 + [_F, _I, _P,
                                                              _P]),
    },
    "conv3d": {
        "hv_conv3d_stride1": (
            _I, [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    },
    "conv3d_v2": {
        "hv_conv3d_stride1_v2": (
            _I, [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    },
    "sta_direct": {
        "hv_sta_tile_codes": (
            _I, [_I, _I, _P, _LL, _LL, _P, _LL, _LL] + [_I] * 8 + [_P] * 5),
        "hv_sta_direct_fwd": (
            _I, [_I] * 3 + [_P] * 13 + [_I] * 12 + [_LL] * 12 + [_F, _P]),
        "hv_sta_ring_fwd": (
            _I, [_I] * 2 + [_P] * 8 + [_I] * 12 + [_LL] * 12 + [_F, _P]),
    },
    "sta_permuted": {
        "hv_sta_permuted_codes": (
            _I, [_I, _I, _P, _LL, _LL, _P, _LL, _LL] + [_I] * 5 + [_P] * 5),
        "hv_sta_permuted_fwd": (
            _I, [_I] * 4 + [_P] * 9 + [_I] * 10 + [_LL] * 9 + [_F, _P]),
    },
    "flash_int8": {
        "hv_quantize_groups": (
            _I, [_I, _I, _P, _LL, _LL, _I, _I, _P, _LL, _LL, _I, _I, _I, _I,
                 _P, _P, _P, _P, _P, _P]),
        "hv_flash_int8_fwd": (
            _I, [_I] * 3 + [_P] * 10 + [_I] * 5 + [_LL] * 2 + [_F, _P]),
    },
    "w8a8_linear": {
        "hv_w8a8_quantize": (
            _I, [_I, _P, _LL, _P, _P, _I, _P, _I, _I, _I, _P]),
        "hv_w8a8_linear": (
            _I, [_I, _I, _P, _LL, _P, _LL, _P, _P, _I] + [_P] * 4
            + [_I] * 8 + [_P]),
    },
    "qk_rope": {
        "hv_qk_norm_rope": (
            _I, [_I, _I, _P, _P] + [_LL] * 6 + [_P] * 4 + [_I, _P, _P]
            + [_I] * 3 + [_F, _P]),
    },
    "flash_backward": {
        "hv_flash_bwd_dq": (
            _I, [_I] * 2 + [_P] * 8 + [_I] * 4 + [_LL] * 6 + [_F, _P]),
        "hv_flash_bwd_dkv": (
            _I, [_I] * 2 + [_P] * 9 + [_I] * 4 + [_LL] * 6 + [_F, _P]),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("HVTORCH_BUILD_DIR")
    if env:
        return Path(env)
    return CSRC.parent.parent / "build" / "cuda"


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "CUDA kernels need nvcc, and no CUDA toolkit was found "
            "(set CUDA_HOME); there is no fallback for CUDA tensors")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def library_path(name: str) -> Path:
    """Where the library of `csrc/<name>.cu` lives for the current sources."""
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among `names` (default: all), one
    nvcc process per source, started together. Returns name -> path."""
    names = list(SIGNATURES) if names is None else list(names)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = []
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir())
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{n}.cu")]
        procs.append((n, p, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, p, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, p)  # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t "
                           f"{err}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
