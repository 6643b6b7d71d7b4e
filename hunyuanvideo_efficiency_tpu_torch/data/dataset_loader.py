"""Video tensor dataset: sorted `.pt` dir -> (tensor, filename) (JAX
counterpart: data/dataset_loader.py; reference:
dataset_processor/dataset_loader.py:9-25). Tensors are stored in torch's
format by the preprocessing tools and load on the CPU as fp32."""
from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import torch


class VideoTensorDataset:
    def __init__(self, tensor_dir: str):
        self.tensor_dir = tensor_dir
        self.files: List[str] = sorted(
            f for f in os.listdir(tensor_dir) if f.endswith(".pt"))

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> Tuple[torch.Tensor, str]:
        path = os.path.join(self.tensor_dir, self.files[idx])
        t = torch.load(path, map_location="cpu", weights_only=True)
        return t.float(), self.files[idx]

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, str]]:
        for i in range(len(self)):
            yield self[i]


def save_tensor(path: str, arr) -> None:
    """Save an array or tensor in the reference's torch format."""
    torch.save(torch.as_tensor(arr), path)
