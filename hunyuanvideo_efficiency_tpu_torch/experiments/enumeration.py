"""Temporal-ops experiment enumeration (a copy of the JAX package's
experiments/enumeration.py; its JSON is the same, file for file).

Generates exp_{n}.json configs in the reference's t_ops_config.json schema
(reference: dynamic_enumeration.py:10-121, dynamic_enumeration_stride.py:
1-135, dynamic_enumeration_stride_2.py:1-106):

* mode "pool":   one-hot (encoder pool slot) x one-hot (decoder interp slot)
  combinations, capped (reference cap 384);
* mode "stride": 3 encoder temporal-stride-doubling variants (block0
  [1,2,2]->[2,2,2]; block1/2 [2,2,2]->[4,2,2]) x decoder interp slots;
* mode "stride2": choose-2 encoder stride blocks x choose-2 decoder interp
  slots.

The emitted JSON is consumed by the port's infer entry, `--config-json`
(TOpsConfig.from_json).
"""
from __future__ import annotations

import copy
import itertools
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

# HunyuanVideo "884" VAE block geometry: 4 encoder down blocks x 2 resnets,
# 4 decoder up blocks x 3 resnets, default downsample strides.
ENC_BLOCKS = 4
ENC_RESNETS = 2
DEC_BLOCKS = 4
DEC_RESNETS = 3
DEFAULT_DOWN_STRIDES = [[1, 2, 2], [2, 2, 2], [2, 2, 2], [1, 1, 1]]


def base_config() -> Dict:
    """All-disabled t-ops config (the reference's t_ops_config.json)."""
    enc_blocks = []
    for i in range(ENC_BLOCKS):
        enc_blocks.append({
            "block_type": "DownEncoderBlockCausal3D",
            "block_index": i,
            "pool_t_kernel": 3,
            "pool_t_stride": 2,
            "enable_t_pool_before_block": [False] * ENC_RESNETS,
            "enable_t_pool_after_block": [False] * ENC_RESNETS,
            "downsample_stride": list(DEFAULT_DOWN_STRIDES[i]),
        })
    dec_blocks = []
    for i in range(DEC_BLOCKS):
        dec_blocks.append({
            "block_type": "UpDecoderBlockCausal3D",
            "block_index": i,
            "interp_t_scale_factor": 2,
            "interp_mode": "nearest",
            "enable_t_interp_before_block": [False] * DEC_RESNETS,
            "enable_t_interp_after_block": [False] * DEC_RESNETS,
        })
    return {
        "encoder": {
            "down_blocks": enc_blocks,
            "mid_block": {
                "mid_block_type": "UNetMidBlockCausal3D",
                "pool_t_kernel": 3,
                "pool_t_stride": 2,
                "enable_t_pool_before_block": [False, False],
                "enable_t_pool_after_block": [False, False],
            },
        },
        "decoder": {
            "up_blocks": dec_blocks,
            "mid_block": {
                "mid_block_type": "UNetMidBlockCausal3D",
                "pool_t_kernel": 3,
                "pool_t_stride": 2,
                "enable_t_pool_before_block": [False, False],
                "enable_t_pool_after_block": [False, False],
            },
        },
    }


def _encoder_pool_slots() -> List[Tuple[int, str, int]]:
    """(block, where, resnet) one-hot pool sites."""
    return [(b, w, r) for b in range(ENC_BLOCKS)
            for w in ("before", "after") for r in range(ENC_RESNETS)]


def _decoder_interp_slots() -> List[Tuple[int, str, int]]:
    return [(b, w, r) for b in range(DEC_BLOCKS)
            for w in ("before", "after") for r in range(DEC_RESNETS)]


def _arm_pool(cfg: Dict, slot: Tuple[int, str, int]) -> None:
    b, w, r = slot
    cfg["encoder"]["down_blocks"][b][f"enable_t_pool_{w}_block"][r] = True


def _arm_interp(cfg: Dict, slot: Tuple[int, str, int]) -> None:
    b, w, r = slot
    cfg["decoder"]["up_blocks"][b][f"enable_t_interp_{w}_block"][r] = True


def _stride_variants() -> List[Tuple[int, List[int]]]:
    """(block, new_stride): temporal stride doubling
    (reference: dynamic_enumeration_stride.py:62-83)."""
    return [(0, [2, 2, 2]), (1, [4, 2, 2]), (2, [4, 2, 2])]


def enumerate_configs(mode: str = "pool", cap: int = 384) -> Iterator[Dict]:
    """Yield experiment configs for the given mode."""
    if mode == "pool":
        for pool_slot, interp_slot in itertools.islice(
                itertools.product(_encoder_pool_slots(),
                                  _decoder_interp_slots()), cap):
            cfg = base_config()
            _arm_pool(cfg, pool_slot)
            _arm_interp(cfg, interp_slot)
            yield cfg
    elif mode == "stride":
        for (blk, stride), interp_slot in itertools.islice(
                itertools.product(_stride_variants(),
                                  _decoder_interp_slots()), cap):
            cfg = base_config()
            cfg["encoder"]["down_blocks"][blk]["downsample_stride"] = stride
            _arm_interp(cfg, interp_slot)
            yield cfg
    elif mode == "stride2":
        for strides, interps in itertools.islice(itertools.product(
                itertools.combinations(_stride_variants(), 2),
                itertools.combinations(_decoder_interp_slots(), 2)), cap):
            cfg = base_config()
            for blk, stride in strides:
                cfg["encoder"]["down_blocks"][blk]["downsample_stride"] = \
                    list(stride)
            for slot in interps:
                _arm_interp(cfg, slot)
            yield cfg
    else:
        raise ValueError(f"Unknown enumeration mode: {mode}")


def write_configs(output_dir: str, mode: str = "pool", cap: int = 384
                  ) -> List[str]:
    """exp_1.json .. exp_N.json (reference numbering starts at 1)."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for n, cfg in enumerate(enumerate_configs(mode, cap), start=1):
        path = os.path.join(output_dir, f"exp_{n}.json")
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2)
        paths.append(path)
    return paths
