"""Cluster contraction (paper §5, Graph Contraction) — host side.

Port of ``repro.core.contraction``: deduplicates inter-cluster arcs and
accumulates vertex/edge weights. ``dedup_arcs`` is numpy on the composed
path and the ``seg_merge`` CUDA kernel on the fused one."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..graphs.format import Graph, from_coo
from ..kernels import dispatch


def dedup_arcs(csrc: np.ndarray, cdst: np.ndarray, w: np.ndarray,
               kernel: str = "composed", device=None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop self loops and merge parallel arcs (summing weights).

    Returns (src, dst, w) int64 arrays sorted by (src, dst).
    ``kernel="fused"`` routes through the seg_merge kernel on ``device``
    (bit-identical; raises when the records exceed the kernel's int32
    envelope).
    """
    dev = dispatch.resolve_device(device)
    if dispatch.resolve_kernel_mode(kernel, dev) == "fused":
        from ..kernels.seg_merge import ops as seg_ops
        return seg_ops.dedup_arcs_fused(csrc, cdst, w, dev)
    keep = csrc != cdst
    csrc, cdst, w = csrc[keep], cdst[keep], w[keep]
    if csrc.size == 0:
        return (csrc.astype(np.int64), cdst.astype(np.int64),
                w.astype(np.int64))
    order = np.lexsort((cdst, csrc))
    csrc, cdst, w = csrc[order], cdst[order], w[order]
    first = np.concatenate(
        [[True], (csrc[1:] != csrc[:-1]) | (cdst[1:] != cdst[:-1])])
    seg = np.cumsum(first) - 1
    merged = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
    np.add.at(merged, seg, w)
    return (csrc[first].astype(np.int64), cdst[first].astype(np.int64),
            merged)


def contract(g: Graph, labels: np.ndarray, kernel: str = "composed",
             device=None) -> Tuple[Graph, np.ndarray]:
    """Contract clustering ``labels`` (arbitrary ids). Returns
    (coarse_graph, fine_to_coarse) with fine_to_coarse[v] in [0, n_c)."""
    uniq, cl = np.unique(labels, return_inverse=True)
    nc = int(uniq.size)
    cvw = np.zeros(nc, dtype=np.int64)
    np.add.at(cvw, cl, g.vweights)
    src = g.arc_tails()
    csrc, cdst, w = dedup_arcs(cl[src], cl[g.adjncy], g.eweights,
                               kernel=kernel, device=device)
    gc = from_coo(nc, csrc, cdst, eweights=w, vweights=cvw,
                  symmetrize=False, dedup=False)
    return gc, cl.astype(np.int64)
