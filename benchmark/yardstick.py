"""The benchmark's yardstick: the card's peaks, the roofline bound and the
kernel categories of a device trace, frozen copies so that later changes to
the program do not move them. Imports nothing of the program.

Copied from:
  PEAK_*, bound()      chip_smoke.py:252-254, :311-317 (NVIDIA's H100 SXM
                       data sheet, dense rates)
  category()           scripts/torch_profile.py:63-100
  NCCL rule            hunyuanvideo_efficiency_tpu_torch/utils/profiling.py:
                       kernel_category
"""
from __future__ import annotations

import re

PEAK_FLOPS = 989e12     # H100 SXM dense bf16/fp16 tensor-core rate
PEAK_INT8 = 1979e12     # H100 SXM dense int8 tensor-core rate
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 rate


def bound(flops, nbytes, int8_ops=0):
    """Least time in ms: bf16 `flops` and `int8_ops` at their peak rates,
    against `nbytes` at the memory rate."""
    t_ops = flops / PEAK_FLOPS + int8_ops / PEAK_INT8
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# the LSE instantiation of csrc/flash_attention.cu's forward template:
# flash_fwd_kernel<T, D, RUNNING=true, LSE=true>
LSE_FORWARD = re.compile(
    r"flash_fwd_kernel<[^>]*(true|\(bool\)1), (true|\(bool\)1)>")
# the RING instantiation of csrc/sta_direct.cu's kernel template:
# sta_direct_kernel<T, D, QUANT, RING=true>
RING_STA = re.compile(r"sta_direct_kernel<[^>]*, (true|\(bool\)1)>")

GLUE = "other (elementwise, norms, copies, reductions)"


def category(name: str) -> str:
    low = name.lower()
    if "nccl" in low:
        return "NCCL"
    if LSE_FORWARD.search(low):
        return "flash forward with LSE (B5f)"
    if "flash_bwd_dq_kernel" in low:
        return "flash backward dQ (B5q)"
    if "flash_bwd_dkv_kernel" in low:
        return "flash backward dK/dV (B5kv)"
    if "flash_fwd_kernel" in low or "flash_combine_kernel" in low:
        return "flash attention (K1/K2)"   # with its key-range split merge
    if "flash_int8_kernel" in low or "quantize_groups_kernel" in low:
        return "int8 flash attention (B8a/B8b)"
    if "w8a8" in low or "quant_rows_kernel" in low:
        return "W8A8 linear (B9)"
    if RING_STA.search(low):
        return "STA ring (B10)"
    if any(k in low for k in ("sta_direct_kernel", "tile_codes_kernel",
                              "sta_permuted_kernel")):
        return "sliding-tile attention (STA)"   # B4/B4q, B6/B6q/B7 and the
                                                # int8 pre-passes
    if "conv3d_s1_kernel" in low:
        return "conv3d (K3)"
    if "conv3d_v2_kernel" in low:
        return "conv3d v2 (B11)"
    if "cudnn" in low or "fprop" in low:
        return "other conv (cuDNN)"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "GEMM (cuBLAS)"
    return GLUE
