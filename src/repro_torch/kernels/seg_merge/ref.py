"""Plain-PyTorch version of the ``seg_merge`` CUDA kernel.

Stable lexicographic sort of (src, dst) with ``w`` as payload, run-start
flags, and each record's run total: the JAX package's ``seg_merge_ref``
op for op. The wrapper runs it for CPU tensors; the chip check holds the
kernel to it.
"""
from __future__ import annotations

import torch

from ...core.lp import cumsum32, segment_sum


def seg_merge_ref(src, dst, w):
    """``(s_src, s_dst, tot, first)`` for (L,) int32 records."""
    L = src.shape[0]
    # full-range int32 keys do not pack into one int64: two stable passes,
    # minor key first, give the stable lexicographic order
    order = torch.sort(dst, stable=True).indices
    order = order[torch.sort(src[order], stable=True).indices]
    s_src, s_dst, s_w = src[order], dst[order], w[order]
    first = torch.ones(L, dtype=torch.bool, device=src.device)
    first[1:] = (s_src[1:] != s_src[:-1]) | (s_dst[1:] != s_dst[:-1])
    gid = (cumsum32(first.to(torch.int32)) - 1).long()
    tot = segment_sum(s_w, gid, L)
    return s_src, s_dst, tot[gid], first.to(torch.int32)
