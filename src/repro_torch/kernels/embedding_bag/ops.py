"""EmbeddingBag entry point over the ``embedding_bag`` kernel.

The JAX package's ``repro/kernels/embedding_bag/ops.py::embedding_bag``
pads D to the TPU's 128 lanes; the CUDA kernel takes any D, so the table
goes to the device as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dispatch import resolve_device
from .embedding_bag import embedding_bag_1row


def embedding_bag(idx: np.ndarray, table: np.ndarray, device=None
                  ) -> np.ndarray:
    """idx (B, BAG) int, table (V, D) -> (B, D) f32 sum-pooled, on
    ``device`` (default: the CUDA device; ``"cpu"`` runs the plain
    version). An index outside [0, V) raises."""
    dev = resolve_device(device)
    out = embedding_bag_1row(
        torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32)).to(dev),
        torch.from_numpy(np.ascontiguousarray(table, dtype=np.float32))
        .to(dev))
    return out.cpu().numpy()
