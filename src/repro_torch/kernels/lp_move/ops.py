"""Host-side ELL construction + chunk loop of the fused LP move kernel.

The composed clustering path feeds ``core.lp.cluster_iteration`` padded
arc slabs (B, m_pad). The fused kernel takes the same chunks in ELL form,
one row per chunk vertex and D padded neighbor lanes. Chunk vertex ranges
come from ``core.lp.chunk_bounds``: identical ranges and the identical
per-chunk salt stream keep the fused iteration bit-identical to the
composed one.

The lanes are padded to a multiple of a warp (32), not the TPU's 128:
padded lanes are inert, so the result cannot change. Gathers of neighbor
labels / cluster weights stay torch ops around the kernel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core import lp
from ...core.lp import I32_MAX
from .lp_move import lp_move_chunk

LANE = 32           # ELL neighbor lanes padded to the warp width


@dataclasses.dataclass(frozen=True)
class MoveChunks:
    """Padded per-chunk ELL slabs for the fused LP move kernel.

    Row ``r`` of chunk ``b`` is vertex ``v0[b] + r``; rows beyond the
    chunk's true vertex range (and neighbor lanes beyond a vertex's
    degree) carry sentinel ``idx = -1`` / ``w = 0`` and can never move.
    """
    idx: np.ndarray   # (B, R, D) int32 neighbor vertex ids, -1 padding
    w: np.ndarray     # (B, R, D) int32 arc weights, 0 padding
    v0: np.ndarray    # (B,) int32 first vertex id of each chunk
    n: int            # true vertex count
    n_pad: int        # padded vertex count == composed sentinel id
    num_chunks: int

    @property
    def shape(self):
        return self.idx.shape


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def ell_from_csr(indptr: np.ndarray, adjncy: np.ndarray,
                 eweights: np.ndarray, D: int):
    """Dense (n, D) neighbor-id / weight tables from CSR; -1 / 0 padding."""
    n = indptr.shape[0] - 1
    deg = np.diff(indptr)
    idx = np.full((n, D), -1, dtype=np.int32)
    w = np.zeros((n, D), dtype=np.int32)
    if adjncy.shape[0]:
        rows = np.repeat(np.arange(n), deg)
        pos = np.arange(adjncy.shape[0]) - np.repeat(indptr[:-1], deg)
        idx[rows, pos] = adjncy
        w[rows, pos] = eweights
    return idx, w


def build_move_chunks(g, num_chunks: int) -> MoveChunks:
    """ELL twin of ``core.lp.build_chunks`` (same bounds; pow-2 rows,
    warp-multiple neighbor width)."""
    if g.total_eweight >= 2**31 or g.total_vweight >= 2**31:
        raise ValueError(
            f"build_move_chunks: total vertex/edge weight "
            f"({g.total_vweight}/{g.total_eweight}) must be < 2^31")
    n = g.n
    bounds = lp.chunk_bounds(g, num_chunks)
    B = len(bounds) - 1
    deg = np.diff(g.indptr)
    D = _round_up(int(deg.max()) if deg.size else 1, LANE)
    R = lp._next_pow2(max(bounds[b + 1] - bounds[b] for b in range(B)))
    idx_full, w_full = ell_from_csr(np.asarray(g.indptr),
                                    np.asarray(g.adjncy, dtype=np.int64),
                                    np.asarray(g.eweights), D)
    idx = np.full((B, R, D), -1, dtype=np.int32)
    w = np.zeros((B, R, D), dtype=np.int32)
    for b in range(B):
        r0, r1 = bounds[b], bounds[b + 1]
        idx[b, :r1 - r0] = idx_full[r0:r1]
        w[b, :r1 - r0] = w_full[r0:r1]
    return MoveChunks(idx=idx, w=w,
                      v0=np.asarray(bounds[:-1], dtype=np.int32),
                      n=n, n_pad=lp._next_pow2(n), num_chunks=B)


def chunk_operands(labels, cluster_w, c_idx, v0: int, vweights, R: int):
    """Gather one chunk's ELL operands: ``(nlab, ncw, own, vw)``. Rows past
    the label table read its last entry, as JAX's clamping gather does;
    they carry no arcs and never move."""
    num = labels.shape[0]
    rows = torch.clamp(torch.arange(v0, v0 + R, device=labels.device),
                       max=num - 1)
    valid = c_idx >= 0
    nlab = torch.where(valid, labels[torch.where(valid, c_idx, 0).long()], -1)
    ncw = torch.where(valid, cluster_w[torch.where(valid, nlab, 0).long()],
                      I32_MAX)
    return nlab, ncw, labels[rows], vweights[rows]


def _chunk_step(labels, cluster_w, c_idx, c_w, v0: int, salt: int,
                vweights, W: int, R: int):
    """Gather ELL operands, run the kernel, apply the chunk's moves."""
    num = labels.shape[0]
    nlab, ncw, own, vwr = chunk_operands(labels, cluster_w, c_idx, v0,
                                         vweights, R)
    moved, tgt = lp_move_chunk(nlab, c_w, ncw, own, vwr, W, v0, salt, num)
    mrow = moved != 0
    # rows past the label table are JAX's dropped scatter writes
    cnt = min(R, num - v0)
    labels[v0:v0 + cnt] = torch.where(mrow, tgt, own)[:cnt]
    vwm = torch.where(mrow, vwr, 0)
    cluster_w.index_add_(0, tgt.long(), vwm)
    cluster_w.index_add_(0, own.long(), -vwm)
    return labels, cluster_w


def cluster_iteration_fused(labels, cluster_w, chunks_idx, chunks_w, v0s,
                            vweights, max_cluster_weight, seed, *, n):
    """Fused twin of ``core.lp.cluster_iteration``: same salt stream,
    bit-identical (labels, cluster_w) trajectory. Updates ``labels`` and
    ``cluster_w`` in place (the JAX version returns new arrays) and
    returns them. ``v0s`` is a host sequence of chunk start rows."""
    B, R, _ = chunks_idx.shape
    W = int(max_cluster_weight)
    for b, salt in enumerate(lp.chunk_salts(B, seed, 0x85EBCA6B)):
        labels, cluster_w = _chunk_step(
            labels, cluster_w, chunks_idx[b], chunks_w[b], int(v0s[b]),
            salt, vweights, W, R)
    return labels, cluster_w
