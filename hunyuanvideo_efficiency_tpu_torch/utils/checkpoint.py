"""Reading reference checkpoints (JAX counterpart: utils/checkpoint.py).

The port's modules carry the reference state-dict names, so a reference
`.pt` loads with `load_state_dict` unchanged. The reference's fp8 DiT ships
E4M3 weights with a side-car `<checkpoint stem>_map.pt` of one scale per
quantized linear (reference: hyvideo/modules/fp8_optimization.py:85-90);
`load_fp8_dit_checkpoint` reads both.

The text towers come either as the JAX package's flat `.npz` parameter
trees (`text_encoder.npz`, `text_encoder_2.npz`; `load_params_npz`) or as
HF-format state dicts in `text_encoder/` and `text_encoder_2/`
(`load_tower_state_dict`).
"""
from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

# The JAX package's tag for dtypes numpy lacks: the array is stored as raw
# uint8 bytes under "<key>::dtype=<name>" (JAX utils/checkpoint.py:361-390).
_DTYPE_TAG = "::dtype="
_TAGGED_TORCH_DTYPES = {"bfloat16": torch.bfloat16,
                        "float8_e4m3fn": torch.float8_e4m3fn,
                        "float8_e5m2": torch.float8_e5m2}


def _untag(raw: np.ndarray, dtype_name: str) -> np.ndarray:
    """Raw bytes of a tagged array -> numpy: through ml_dtypes where it is
    installed (the exact dtype), else through torch's dtype of that name,
    widened to float32 (exact for bfloat16 and the float8 types)."""
    try:
        import ml_dtypes

        return raw.view(np.dtype(getattr(ml_dtypes, dtype_name)))
    except ImportError:
        dt = _TAGGED_TORCH_DTYPES.get(dtype_name)
        if dt is None:
            raise ValueError(f"tagged dtype {dtype_name!r} needs ml_dtypes")
        t = torch.from_numpy(np.ascontiguousarray(raw)).view(dt)
        return t.float().numpy()


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """"a/0/b"-keyed leaves -> nested dicts, all-digit levels as lists."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def listify(n):
        if isinstance(n, dict):
            n = {k: listify(v) for k, v in n.items()}
            if n and all(k.isdigit() for k in n):
                return [n[str(i)] for i in range(len(n))]
        return n

    return listify(tree)


def load_params_npz(path) -> Any:
    """A parameter tree saved by the JAX package's `save_params_npz` (flat
    "/"-joined keys, exotic dtypes tagged), as nested dicts of numpy
    arrays, ready for `utils.weights`' converters."""
    flat = {}
    with np.load(path) as z:
        for k in z.files:
            v = z[k]
            if _DTYPE_TAG in k:
                k, dtype_name = k.split(_DTYPE_TAG)
                v = _untag(v, dtype_name)
            flat[k] = v
    return _unflatten(flat)


# Prefixes of the HF tower checkpoints that the port's bare modules lack,
# and keys they carry that are no weights of the port's modules.
_TOWER_PREFIX = {"llm": "model.", "clipL": "text_model."}
_TOWER_EXTRA = {"llm": ("lm_head.weight",),
                "clipL": ("embeddings.position_ids",)}


def load_tower_state_dict(directory, kind: str
                          ) -> Optional[Dict[str, torch.Tensor]]:
    """The state dict of a text tower in HF format under `directory`, or
    None when it holds none: every `*.safetensors` file (when safetensors
    is installed), else every `*.bin` / `*.pt` file, merged. The Llama
    tower's `model.` and CLIP's `text_model.` prefixes are stripped
    (reference: hyvideo/text_encoder/__init__.py load_text_encoder; the
    port's CLIPTextModel is the bare text model, models/text/clip.py), and
    the LM head and CLIP's legacy `position_ids` buffer are dropped."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    files = []
    try:
        from safetensors.torch import load_file

        files = [(f, load_file) for f in sorted(directory.glob("*.safetensors"))]
    except ImportError:
        pass
    if not files:
        files = [(f, lambda f: torch.load(f, map_location="cpu",
                                          weights_only=True))
                 for f in sorted(directory.glob("*.bin"))
                 + sorted(directory.glob("*.pt"))]
    if not files:
        return None
    sd: Dict[str, torch.Tensor] = {}
    for f, load in files:
        sd.update(load(f))
    return tower_keys(sd, kind)


def tower_keys(sd: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """An HF tower state dict under the port's names: the `model.` /
    `text_model.` prefix stripped where present, the LM head and CLIP's
    `position_ids` buffer dropped."""
    prefix = _TOWER_PREFIX[kind]
    if any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    return {k: v for k, v in sd.items() if k not in _TOWER_EXTRA[kind]}


def load_torch_state_dict(path, load_key: str = "module",
                          prefix: str = "") -> Dict[str, torch.Tensor]:
    """A reference checkpoint's state dict: bare, under `load_key` (the
    deepspeed `module`/`ema` forms) or under `state_dict`, with an optional
    key prefix stripped (reference: hyvideo/inference.py:279-354,
    hyvideo/vae/__init__.py:94-102)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and load_key in sd:
        sd = sd[load_key]
    elif isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if prefix and any(k.startswith(prefix) for k in sd):
        sd = {k[len(prefix):]: v for k, v in sd.items()
              if k.startswith(prefix)}
    return sd


def fp8_map_path(dit_path) -> Path:
    """The scale side-car of an fp8 DiT checkpoint: `<stem>_map.pt`."""
    dit_path = Path(dit_path)
    return dit_path.with_name(dit_path.stem + "_map.pt")


def fp8_checkpoint_state_dict(ckpt_path, map_path, load_key: str = "module"):
    """A reference fp8 checkpoint's state dict on the host, its fp8 weights
    upcast and multiplied by their side-car scales in fp32 (JAX
    utils/checkpoint.py:215-239)."""
    sd = load_torch_state_dict(ckpt_path, load_key)
    for name, scale in load_torch_state_dict(map_path).items():
        key = name if name in sd else name.replace(".scale", ".weight")
        if key in sd:
            sd[key] = sd[key].float() * torch.as_tensor(scale).float()
    return sd


def load_fp8_dit_checkpoint(ckpt_path, map_path, cfg,
                            load_key: str = "module", device="cuda",
                            dtype=torch.bfloat16):
    """An HYVideoDiT from a reference fp8 checkpoint and its scale map: the
    upcast state dict (fp8_checkpoint_state_dict) loaded through `dtype`,
    and the block linears re-quantized to the per-tensor fp8 tier."""
    from ..models.dit import build_dit
    from ..ops.quantization import quantize_dit

    model = build_dit(cfg, device, dtype)
    model.load_state_dict(fp8_checkpoint_state_dict(ckpt_path, map_path,
                                                    load_key))
    return quantize_dit(model, fp8=True)
