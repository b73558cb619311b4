"""EmbeddingBag entry point over the ``embedding_bag`` kernel.

The JAX package's ``repro/kernels/embedding_bag/ops.py::embedding_bag``
pads D to the TPU's 128 lanes; the CUDA kernel takes any D, so the table
goes to the device as it is. The indices arrive on the host and are
checked there, before anything is copied to the device, so the launch
neither checks them on the device nor waits for the stream.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..dispatch import resolve_device
from .embedding_bag import _gather


def embedding_bag(idx: np.ndarray, table: np.ndarray, device=None
                  ) -> np.ndarray:
    """idx (B, BAG) int, table (V, D) -> (B, D) f32 sum-pooled, on
    ``device`` (default: the CUDA device; ``"cpu"`` runs the plain
    version). An index outside [0, V) raises ``ValueError``."""
    idx_t = torch.from_numpy(np.ascontiguousarray(idx, dtype=np.int32))
    table = np.ascontiguousarray(table, dtype=np.float32)
    _build.check_index_range("embedding_bag idx", idx_t, table.shape[0])
    dev = resolve_device(device)
    out = _gather(idx_t.to(dev), torch.from_numpy(table).to(dev))
    return out.cpu().numpy()
