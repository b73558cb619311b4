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

The stacked forms (``chunk_operands_stacked``,
``cluster_iteration_fused_stacked``) carry a leading request axis: S
requests' tables (S, N) and chunk b of each, (S, R, D), go through one
stacked kernel call a chunk step, with no host round trip in the loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ...core import lp
from ...core.lp import I32_MAX
from .lp_move import lp_move_chunk, lp_move_chunk_stacked

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


# ---------------------------------------------------------------------------
# the request axis: S requests' chunk b in one kernel call
# ---------------------------------------------------------------------------

def stacked_bytes(S: int, B: int, R: int, D: int, N: int) -> int:
    """Peak device bytes of a stacked level-0 clustering of S requests
    over (S, N) tables (``serve.batching._stacked_fused``): the two (B, S,
    R, D) int32 chunk slabs and the three (S, N) int32 tables, plus the
    larger of what is live beside them while the slabs are assembled (one
    request's int32 slab copied in) and during a chunk step: per (S, R, D)
    lane the bool lane mask, the first gathered operand, the second's
    int32 index, the int64 copy the indexing op makes of it and the
    gathered value (21 bytes), and at most 64 bytes a row and 12 a label
    of (S, R) vectors and kernel scratch."""
    step = S * R * D * (1 + 4 + 4 + 8 + 4) + 64 * S * R + 12 * S * N
    return 2 * S * B * R * D * 4 + 3 * S * N * 4 + max(B * R * D * 4, step)


def chunk_operands_stacked(labels, cluster_w, c_idx, v0, vweights):
    """Gather chunk operands for S requests at once: ``(nlab, ncw, own,
    vw, rows, in_table)``. ``labels``, ``cluster_w`` and ``vweights`` are
    (S, N) tables, ``c_idx`` the (S, R, D) neighbour ids (-1 padding) of
    one chunk of each, ``v0`` the (S,) int32 first rows on the device.
    ``rows`` are the chunk rows' flat ids into the (S * N) tables, rows
    past a request's table clamped to its last entry (JAX's clamping
    gather) and flagged off in ``in_table``; they carry no arcs and never
    move."""
    S, N = labels.shape
    R = c_idx.shape[1]
    dev = labels.device
    # int32 lane ids suffice: check_stack_limits holds S * N < 2^31
    base = torch.arange(S, dtype=torch.int32, device=dev)[:, None] * N
    r = v0.to(torch.int64)[:, None] + torch.arange(R, dtype=torch.int64,
                                                   device=dev)
    rows = base + torch.clamp(r, max=N - 1)
    flat_l, flat_cw = labels.view(-1), cluster_w.view(-1)
    valid = c_idx >= 0
    base3 = base[:, :, None]
    nlab = torch.where(valid, flat_l[torch.where(valid, c_idx + base3, 0)],
                       -1)
    ncw = torch.where(valid, flat_cw[torch.where(valid, nlab + base3, 0)],
                      I32_MAX)
    return nlab, ncw, flat_l[rows], vweights.view(-1)[rows], rows, r < N


def _chunk_step_stacked(labels, cluster_w, c_idx, c_w, v0, salt, vweights,
                        W):
    """One chunk step of S requests: gather, one stacked kernel call,
    apply every request's moves. ``labels`` and ``cluster_w`` change in
    place."""
    S, N = labels.shape
    nlab, ncw, own, vwr, rows, in_table = chunk_operands_stacked(
        labels, cluster_w, c_idx, v0, vweights)
    moved, tgt = lp_move_chunk_stacked(nlab, c_w, ncw, own, vwr, W, v0,
                                       salt, N)
    mrow = moved != 0
    # each row's new label as a difference from the one it read, so the
    # clamped rows (JAX's dropped scatter writes) add 0 to the last entry
    labels.view(-1).index_add_(0, rows.view(-1),
                               torch.where(mrow & in_table, tgt - own,
                                           0).view(-1))
    base = torch.arange(S, dtype=torch.int64, device=labels.device)[:, None]
    base *= N
    vwm = torch.where(mrow, vwr, 0).view(-1)
    flat_cw = cluster_w.view(-1)
    flat_cw.index_add_(0, (tgt + base).view(-1), vwm)
    flat_cw.index_add_(0, (own + base).view(-1), -vwm)
    return labels, cluster_w


def cluster_iteration_fused_stacked(labels, cluster_w, chunks_idx, chunks_w,
                                    v0s, vweights, W, salts, *, n):
    """``cluster_iteration_fused`` of S requests in lockstep: row ``s`` of
    the result is bit-identical to the solo iteration of request ``s`` at
    its own shape, padding being inert (rows and lanes past a request's
    own carry ``-1`` lanes and never move; vertices past its table have
    weight 0 and no arcs).

    ``labels``, ``cluster_w``, ``vweights``: (S, n + 1) int32, the first
    two updated in place and returned. ``chunks_idx``/``chunks_w``: (B,
    S, R, D) int32, so chunk ``b`` of every request is one contiguous
    slab. ``v0s``: (B, S) int32 chunk start rows; ``W``: (S,) int32;
    ``salts``: (B, S) int32, this iteration's per-chunk salts (uint32 bit
    patterns). All on one device: the chunk loop makes no host round
    trip."""
    B = chunks_idx.shape[0]
    if labels.shape[1] != n + 1:
        raise ValueError(f"cluster_iteration_fused_stacked: tables of "
                         f"{labels.shape[1]} entries for n={n}")
    for b in range(B):
        labels, cluster_w = _chunk_step_stacked(
            labels, cluster_w, chunks_idx[b], chunks_w[b], v0s[b], salts[b],
            vweights, W)
    return labels, cluster_w
