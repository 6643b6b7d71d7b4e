"""Saving and restoring training state (JAX counterpart: utils/orbax_io.py).

A tree is a nest of dicts whose leaves are tensors or plain numbers, written
with `torch.save` and read back with `torch.load(weights_only=True)`. The
`module` and `ema` files of a training checkpoint are plain state dicts
with the reference's key names, so `utils.checkpoint.load_torch_state_dict`
and `from_pretrained` read them unchanged.
"""
from __future__ import annotations

import os
from typing import Any

import torch


def _map(tree: Any, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def save_tree(path: str, tree: Any) -> None:
    """Write `tree` to `path` (tensors detached and copied to the CPU)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    torch.save(_map(tree, lambda t: t.detach().cpu()), tmp)
    os.replace(tmp, path)


def load_tree(path: str, device="cpu") -> Any:
    """Read a tree written by `save_tree`, its tensors on `device`."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return _map(tree, lambda t: t.to(device))
