"""Environment fingerprint for the CUDA port (JAX counterpart:
utils/collect_env.py; reference: utils/collect_env.py:1-201, the
OpenMMLab-style CUDA dump): Python, torch, its CUDA, each device's name,
capability and memory, the device count, `nvcc --version` and the host
toolchain.

    python -m hunyuanvideo_efficiency_tpu_torch.utils.collect_env
"""
from __future__ import annotations

import os
import platform
import subprocess
import sys
from collections import OrderedDict


def _version_line(cmd, last: bool = False) -> str:
    """The first (or last) line a tool prints, or "not found"."""
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=30,
                             check=True).stdout.strip().splitlines()
        return out[-1 if last else 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not found"


def collect_env() -> "OrderedDict[str, str]":
    import torch

    env = OrderedDict()
    env["sys.platform"] = sys.platform
    env["Python"] = sys.version.replace("\n", "")
    env["OS"] = platform.platform()
    env["CPU count"] = str(os.cpu_count())
    env["torch"] = torch.__version__
    env["torch CUDA"] = str(torch.version.cuda)
    env["CUDA available"] = str(torch.cuda.is_available())
    env["Device count"] = str(torch.cuda.device_count())
    for i in range(torch.cuda.device_count()):
        p = torch.cuda.get_device_properties(i)
        env[f"GPU {i}"] = (f"{p.name}, capability {p.major}.{p.minor}, "
                           f"{p.total_memory / 2**30:.1f} GiB, "
                           f"{p.multi_processor_count} SMs")
    try:
        from ..ops.cuda_lib import nvcc_path

        nvcc = nvcc_path()
    except RuntimeError:  # no CUDA toolkit on this host
        nvcc = "nvcc"
    env["nvcc"] = _version_line([nvcc, "--version"], last=True)
    env["NCCL"] = (".".join(map(str, torch.cuda.nccl.version()))
                   if torch.cuda.is_available() else "not available")
    for mod in ("numpy", "triton", "imageio", "cv2", "gradio"):
        try:
            env[mod] = getattr(__import__(mod), "__version__", "?")
        except ImportError:
            env[mod] = "not installed"
    env["g++"] = _version_line(["g++", "--version"])
    return env


def main():
    for k, v in collect_env().items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
