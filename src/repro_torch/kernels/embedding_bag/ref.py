"""Plain-PyTorch version of the ``embedding_bag`` CUDA kernel.

``out[b] = sum_j table[idx[b, j]]``, accumulated as the kernel does it:
from zero, one table row after the other in j order (not ``.sum(1)``,
whose order is its own), so the two agree bit for bit. The JAX package's
``embedding_bag_ref`` (``jnp.take(...).sum(axis=1)``) agrees with it
exactly up to two rows a bag and within f32 rounding beyond. The wrapper
runs it for CPU tensors; the chip check holds the kernel to it.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(idx, table):
    """(B, D) f32 from idx (B, BAG) int32 and table (V, D) f32."""
    out = torch.zeros(idx.shape[0], table.shape[1], dtype=torch.float32,
                      device=table.device)
    for j in range(idx.shape[1]):
        out += table[idx[:, j].long()]
    return out
