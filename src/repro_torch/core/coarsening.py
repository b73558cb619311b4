"""Coarsening via size-constrained label propagation clustering (paper §4).

Port of ``repro.core.coarsening``. Host side: degree-bucket reorder ->
chunked LP iterations (torch ops on ``device``, or the ``lp_move`` CUDA
kernel) -> exact max-cluster-weight enforcement (a final
eject-to-singleton sweep; multi-member clusters are always reducible below
W, singletons heavier than W are tolerated as in the paper).
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs.format import Graph, degree_bucket_order, permute
from ..kernels import dispatch
from ..kernels.lp_move import ops as move_ops
from . import lp


def ejection_candidates(labels: np.ndarray, vweights: np.ndarray,
                        max_weight: int) -> np.ndarray:
    """Vertices that must leave their overweight cluster, under the
    deterministic keep-heaviest-first-prefix rule: members sort by
    (cluster, -weight, id) and a member is ejected once the cumulative
    kept weight including it exceeds ``max_weight`` — except each
    cluster's first (heaviest) member, since singletons may legitimately
    exceed W."""
    n = labels.shape[0]
    cw = np.zeros(n, dtype=np.int64)
    np.add.at(cw, labels, vweights)
    over = cw > max_weight
    if not over.any():
        return np.empty(0, dtype=np.int64)
    members = np.flatnonzero(over[labels])
    order = np.lexsort((members, -vweights[members], labels[members]))
    sid = labels[members][order]
    sw = vweights[members][order]
    csum = np.cumsum(sw)
    starts = np.concatenate([[True], sid[1:] != sid[:-1]])
    gidx = np.cumsum(starts) - 1
    gstart = np.flatnonzero(starts)
    base = (csum[gstart] - sw[gstart])[gidx]
    within = csum - base
    eject = (within > max_weight) & ~starts
    return members[order][eject].astype(np.int64)


def enforce_cluster_weights(labels: np.ndarray, vweights: np.ndarray,
                            max_weight: int) -> np.ndarray:
    """Eject members of overweight clusters into fresh singleton clusters
    until every multi-member cluster fits. One exact pass."""
    n = labels.shape[0]
    ej = ejection_candidates(labels, vweights, max_weight)
    if ej.size == 0:
        return labels
    used = np.zeros(n, dtype=bool)
    keep_members = np.setdiff1d(np.arange(n), ej, assume_unique=False)
    used[labels[keep_members]] = True
    free = np.flatnonzero(~used)
    if free.size < ej.size:
        raise RuntimeError("no free cluster ids for ejection")
    out = labels.copy()
    out[ej] = free[:ej.size]
    return out


def cluster_prepare(g: Graph, num_chunks: int, seed: int,
                    kernel: str = "composed", device=None):
    """Host-side setup: seeded degree-bucket reorder, permuted graph,
    padded chunk slabs. Returns ``(perm, g2, chunks)``.

    ``kernel="fused"`` builds ELL slabs for the ``lp_move`` kernel instead
    of arc slabs; both describe identical vertex ranges
    (``lp.chunk_bounds``). Their bytes are checked against the host's
    limit and the free memory of ``device`` (CUDA) before they are built
    (``dispatch.EllTooLarge``)."""
    n = g.n
    rng = np.random.default_rng(seed)
    order = degree_bucket_order(g, rng)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    g2, _ = permute(g, perm)
    if kernel == "fused":
        return perm, g2, move_ops.build_move_chunks(g2, num_chunks,
                                                    device=device)
    return perm, g2, lp.build_chunks(g2, num_chunks)


def cluster_seed(seed: int, iteration: int) -> int:
    """The device-side salt stream for LP-clustering iteration ``it``."""
    return (seed * 1000003 + iteration) % (2**32)


def cluster_finish(labels_pad: np.ndarray, g2: Graph, perm: np.ndarray,
                   max_cluster_weight: int) -> np.ndarray:
    """Slice the padded label vector to the real vertices, exactly enforce
    the cluster-weight bound, and map the labels back to the input
    graph's vertex numbering."""
    n = g2.n
    lab2 = np.asarray(labels_pad)[:n].astype(np.int64)
    lab2 = enforce_cluster_weights(lab2, np.asarray(g2.vweights),
                                   int(max_cluster_weight))
    return lab2[perm]


def cluster(g: Graph,
            max_cluster_weight: int,
            num_iterations: int = 3,
            num_chunks: int = 8,
            seed: int = 0,
            kernel: str = "auto",
            device=None) -> np.ndarray:
    """Size-constrained LP clustering. Returns cluster labels (n,) in the
    input graph's vertex numbering; label values are arbitrary ids.

    ``kernel`` selects the chunk-move implementation (see
    ``kernels.dispatch``); "fused" and "composed" produce bit-identical
    labels. ``device`` is where the iterations run (default: CUDA)."""
    dev = dispatch.resolve_device(device)
    n = g.n
    if n <= 1:
        return np.zeros(n, dtype=np.int64)
    mode = dispatch.resolve_kernel_mode(kernel, dev)
    perm, g2, chunks = cluster_prepare(g, num_chunks, seed, kernel=mode,
                                       device=dev)
    W = max(1, int(max_cluster_weight))
    labels = cluster_labels(g2, chunks, W, num_iterations, seed, dev)
    return cluster_finish(labels.cpu().numpy(), g2, perm, W)


def cluster_labels(g2: Graph, chunks, W: int, num_iterations: int,
                   seed: int, dev) -> torch.Tensor:
    """The LP iterations of ``cluster`` on ``cluster_prepare``'s output:
    the padded (n_pad + 1,) int32 labels on ``dev``."""
    n = g2.n
    np_pad = chunks.n_pad
    labels = torch.arange(np_pad + 1, dtype=torch.int32, device=dev)
    vw_np = np.zeros(np_pad + 1, dtype=np.int32)
    vw_np[:n] = g2.vweights
    vw = torch.from_numpy(vw_np).to(dev)
    cluster_w = vw.clone()
    if isinstance(chunks, move_ops.MoveChunks):
        idx = torch.from_numpy(chunks.idx).to(dev)
        cw_slab = torch.from_numpy(chunks.w).to(dev)
        overflow = [None if o is None else
                    tuple(torch.from_numpy(x).to(dev) for x in o)
                    for o in chunks.overflow]
        for it in range(num_iterations):
            labels, cluster_w = move_ops.cluster_iteration_fused(
                labels, cluster_w, idx, cw_slab, chunks.v0, vw, W,
                cluster_seed(seed, it), n=np_pad, overflow=overflow)
    else:
        src = torch.from_numpy(chunks.src).to(dev)
        dst = torch.from_numpy(chunks.dst).to(dev)
        w = torch.from_numpy(chunks.w).to(dev)
        for it in range(num_iterations):
            labels, cluster_w = lp.cluster_iteration(
                labels, cluster_w, src, dst, w, vw, W,
                cluster_seed(seed, it), n=np_pad)
    return labels
