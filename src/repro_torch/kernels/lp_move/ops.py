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

Hub rows. The slab's width D is the largest degree rounded up to a warp,
capped by ``slab_width``'s rule: D_cap = max(32, 32 * floor(2 m / (32
rows))) for ``rows`` slab rows over ``m`` arcs, so the slab holds at
most max(32 rows, 2 m) lanes. A row of a larger degree keeps its first D
arcs in the slab; the rest go to its chunk's ``Overflow`` (CSR form, at
most m arcs in all), and the kernel takes such rows by a path of their
own. Slab plus overflow therefore stay within max(32 rows, 2 m) + m
lanes (8 bytes each), at most 3x the CSR's 8 m arc bytes once m >= 16
rows; below that, a warp's 32 lanes a row bound the slab, as before the
cap. A graph whose largest degree is at most 32 (the rgg2d main path)
has no overflow at all. Every build checks its bytes from the degree
array before it allocates (``dispatch.check_ell_bytes``).

The stacked forms (``chunk_operands_stacked``,
``cluster_iteration_fused_stacked``) carry a leading request axis: S
requests' tables (S, N) and chunk b of each, (S, R, D), go through one
stacked kernel call a chunk step, with no host round trip in the loop.
They take no overflow: the batcher serves a request with overflow rows
solo.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...core import lp
from ...core.lp import I32_MAX
from .. import dispatch
from ..heavy import HUB_RANGE, heavy_plan
from .lp_move import lp_move_chunk, lp_move_chunk_stacked

LANE = 32           # ELL neighbor lanes padded to the warp width
SLAB_ARC_FACTOR = 2  # D_cap: slab lanes <= max(LANE * rows, 2 m)


class Overflow(NamedTuple):
    """The arcs of a slab's heavy rows beyond its D lanes, in CSR form:
    heavy row ``rows[h]`` (slab-local, ascending) owns arcs ``ptr[h] ..
    ptr[h + 1]`` of ``idx`` / ``w``, which follow its D slab lanes; and
    the heavy-row kernels' work plan over those rows (``heavy.py``)."""
    rows: np.ndarray    # (H,) int32
    ptr: np.ndarray     # (H + 1,) int32, ptr[0] == 0
    idx: np.ndarray     # (M_ov,) int32 neighbor ids
    w: np.ndarray       # (M_ov,) int32 arc weights
    hubs: np.ndarray    # (n_hub + 1, 2) int32: hub rows, hub-lane offsets
    ranges: np.ndarray  # (G,) int32: each hub range's first hub row


@dataclasses.dataclass(frozen=True)
class MoveChunks:
    """Padded per-chunk ELL slabs for the fused LP move kernel.

    Row ``r`` of chunk ``b`` is vertex ``v0[b] + r``; rows beyond the
    chunk's true vertex range (and neighbor lanes beyond a vertex's
    degree) carry sentinel ``idx = -1`` / ``w = 0`` and can never move.
    ``overflow[b]`` holds chunk b's arcs beyond the slab's D lanes, or
    None.
    """
    idx: np.ndarray   # (B, R, D) int32 neighbor vertex ids, -1 padding
    w: np.ndarray     # (B, R, D) int32 arc weights, 0 padding
    v0: np.ndarray    # (B,) int32 first vertex id of each chunk
    n: int            # true vertex count
    n_pad: int        # padded vertex count == composed sentinel id
    num_chunks: int
    overflow: Tuple[Optional[Overflow], ...]

    @property
    def shape(self):
        return self.idx.shape

    @property
    def has_overflow(self) -> bool:
        return any(o is not None for o in self.overflow)

    @property
    def nbytes(self) -> Tuple[int, int]:
        """(slab, overflow) bytes."""
        return (self.idx.nbytes + self.w.nbytes,
                sum(sum(a.nbytes for a in o) for o in self.overflow
                    if o is not None))


def _round_up(x: int, mult: int) -> int:
    return ((max(x, 1) + mult - 1) // mult) * mult


def slab_width(deg: np.ndarray, rows: int) -> int:
    """The ELL width D of ``rows`` slab rows over a graph of degrees
    ``deg``: the largest degree rounded up to a warp, capped at D_cap =
    max(LANE, LANE * floor(SLAB_ARC_FACTOR * m / (LANE * rows)))."""
    full = _round_up(int(deg.max()) if deg.size else 1, LANE)
    m = int(deg.sum())
    cap = max(LANE, LANE * (SLAB_ARC_FACTOR * m // (LANE * max(rows, 1))))
    return min(full, cap)


def split_bytes(deg: np.ndarray, rows: int, D: int, parts: int
                ) -> Tuple[int, int, int]:
    """Bytes of an ELL build of ``rows`` slab rows of width D over degrees
    ``deg`` in ``parts`` chunks: ``(slab, overflow, temporaries)``, the
    int32 slabs, the overflow (rows, pointers, arcs and at most this
    much of heavy-row plan) and ``ell_rows``' host temporaries (two int64
    and one bool an arc, counted for all arcs)."""
    extra = np.maximum(deg.astype(np.int64) - D, 0)
    heavy = int(np.count_nonzero(extra))
    lanes = heavy * D + int(extra.sum())
    plan = 12 * (heavy + parts) + 4 * (lanes // HUB_RANGE)
    return (8 * rows * D,
            4 * (2 * heavy + parts) + 8 * int(extra.sum()) + plan,
            17 * int(deg.sum()))


def ell_rows(indptr: np.ndarray, adjncy: np.ndarray, eweights: np.ndarray,
             r0: int, r1: int, idx: np.ndarray, w: np.ndarray
             ) -> Optional[Overflow]:
    """Fill the (>= r1 - r0, D) tables ``idx`` / ``w`` with the first D
    arcs of vertices ``r0 .. r1`` (row ``v - r0``) and return the arcs
    beyond them as an ``Overflow`` (None when there are none)."""
    D = idx.shape[1]
    deg = np.diff(indptr[r0:r1 + 1])
    a0, a1 = int(indptr[r0]), int(indptr[r1])
    if a1 > a0:
        rows = np.repeat(np.arange(r1 - r0), deg)
        pos = np.arange(a1 - a0) - np.repeat(indptr[r0:r1] - a0, deg)
        keep = pos < D
        idx[rows[keep], pos[keep]] = adjncy[a0:a1][keep]
        w[rows[keep], pos[keep]] = eweights[a0:a1][keep]
    heavy = np.flatnonzero(deg > D)
    if heavy.size == 0:
        return None
    extra = deg[heavy] - D
    ptr = np.zeros(heavy.size + 1, dtype=np.int64)
    np.cumsum(extra, out=ptr[1:])
    arc = np.repeat(indptr[r0 + heavy] + D - ptr[:-1], extra) \
        + np.arange(ptr[-1])
    hubs, ranges = heavy_plan(D + extra)
    return Overflow(rows=heavy.astype(np.int32), ptr=ptr.astype(np.int32),
                    idx=np.asarray(adjncy[arc], dtype=np.int32),
                    w=np.asarray(eweights[arc], dtype=np.int32), hubs=hubs,
                    ranges=ranges)


def build_move_chunks(g, num_chunks: int, device=None) -> MoveChunks:
    """ELL twin of ``core.lp.build_chunks`` (same bounds; pow-2 rows,
    warp-multiple neighbor width capped by ``slab_width``, hub arcs in
    per-chunk overflow). Raises ``dispatch.EllTooLarge`` before it
    allocates when the build would not fit the host, or the card
    (``device``, CUDA)."""
    if g.total_eweight >= 2**31 or g.total_vweight >= 2**31:
        raise ValueError(
            f"build_move_chunks: total vertex/edge weight "
            f"({g.total_vweight}/{g.total_eweight}) must be < 2^31")
    n = g.n
    n_pad = lp._next_pow2(n)
    bounds = lp.chunk_bounds(g, num_chunks)
    B = len(bounds) - 1
    deg = np.diff(g.indptr)
    R = lp._next_pow2(max(bounds[b + 1] - bounds[b] for b in range(B)))
    D = slab_width(deg, B * R)
    slab, over, temp = split_bytes(deg, B * R, D, B)
    # on the card: the slabs, tables and a chunk step (stacked_bytes at
    # S = 1), the overflow and its gathered labels and cluster weights
    dispatch.check_ell_bytes("build_move_chunks", (B, R, D),
                             slab + over + temp,
                             stacked_bytes(1, B, R, D, n_pad + 1) + 2 * over,
                             device)
    idx = np.full((B, R, D), -1, dtype=np.int32)
    w = np.zeros((B, R, D), dtype=np.int32)
    indptr = np.asarray(g.indptr)
    overflow = tuple(ell_rows(indptr, g.adjncy, g.eweights, bounds[b],
                              bounds[b + 1], idx[b], w[b])
                     for b in range(B))
    return MoveChunks(idx=idx, w=w,
                      v0=np.asarray(bounds[:-1], dtype=np.int32),
                      n=n, n_pad=n_pad, num_chunks=B, overflow=overflow)


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


def overflow_operands(labels, cluster_w, ov, budget=None):
    """The kernel's overflow operands of one chunk, ``(rows, ptr, nlab,
    nw, ncw, hubs, ranges)``, from its device ``Overflow``: the overflow
    arcs' labels and cluster weights gathered, in O(overflow), and the
    heavy-row plan; with a label-indexed ``budget`` (the distributed
    admission form), the arcs' budgets after ``ncw``."""
    rows, ptr, o_idx, o_w, hubs, ranges = ov
    nlab = labels[o_idx.long()]
    out = (rows, ptr, nlab, o_w, cluster_w[nlab.long()])
    if budget is not None:
        out += (budget[nlab.long()],)
    return out + (hubs, ranges)


def _chunk_step(labels, cluster_w, c_idx, c_w, v0: int, salt: int,
                vweights, W: int, R: int, ov=None):
    """Gather ELL operands, run the kernel, apply the chunk's moves."""
    num = labels.shape[0]
    nlab, ncw, own, vwr = chunk_operands(labels, cluster_w, c_idx, v0,
                                         vweights, R)
    over = None if ov is None else overflow_operands(labels, cluster_w, ov)
    moved, tgt = lp_move_chunk(nlab, c_w, ncw, own, vwr, W, v0, salt, num,
                               overflow=over)
    mrow = moved != 0
    # rows past the label table are JAX's dropped scatter writes
    cnt = min(R, num - v0)
    labels[v0:v0 + cnt] = torch.where(mrow, tgt, own)[:cnt]
    vwm = torch.where(mrow, vwr, 0)
    cluster_w.index_add_(0, tgt.long(), vwm)
    cluster_w.index_add_(0, own.long(), -vwm)
    return labels, cluster_w


def cluster_iteration_fused(labels, cluster_w, chunks_idx, chunks_w, v0s,
                            vweights, max_cluster_weight, seed, *, n,
                            overflow=None):
    """Fused twin of ``core.lp.cluster_iteration``: same salt stream,
    bit-identical (labels, cluster_w) trajectory. Updates ``labels`` and
    ``cluster_w`` in place (the JAX version returns new arrays) and
    returns them. ``v0s`` is a host sequence of chunk start rows;
    ``overflow``, when given, one entry a chunk: None or its ``Overflow``
    as tensors on the tables' device."""
    B, R, _ = chunks_idx.shape
    W = int(max_cluster_weight)
    for b, salt in enumerate(lp.chunk_salts(B, seed, 0x85EBCA6B)):
        labels, cluster_w = _chunk_step(
            labels, cluster_w, chunks_idx[b], chunks_w[b], int(v0s[b]),
            salt, vweights, W, R, None if overflow is None else overflow[b])
    return labels, cluster_w


# ---------------------------------------------------------------------------
# the distributed engine's chunks: one PE's local vertices
# ---------------------------------------------------------------------------

def local_csr(shards, p: int):
    """PE ``p``'s arcs as a CSR over its ``n_loc`` local rows: ``(indptr,
    dst_idx, w)``, neighbours as indices into the PE's (local + ghost +
    sentinel) label table. Sentinel arcs (src == n_loc) are dropped."""
    n_loc = shards.n_loc
    real = shards.arc_src[p] < n_loc
    sv = shards.arc_src[p][real].astype(np.int64)
    order = np.argsort(sv, kind="stable")
    indptr = np.zeros(n_loc + 1, dtype=np.int64)
    np.cumsum(np.bincount(sv, minlength=n_loc), out=indptr[1:])
    return (indptr, shards.arc_dst_idx[p][real][order],
            shards.arc_w[p][real][order])


@dataclasses.dataclass(frozen=True)
class DistMoveChunks:
    """One PE's ELL chunks for the fused distributed clustering: the ELL
    twin of ``graphs.distribute.chunk_local_arcs`` for that PE. Row ``r``
    of chunk ``b`` is local vertex ``v0[b] + r``; lanes hold indices into
    the PE's label table. Same vertex ranges as the arc chunks, so the
    fused clustering is bit-identical to the composed one; the width is
    capped by ``slab_width``, a hub's further arcs in ``overflow[b]``."""
    idx: np.ndarray   # (B, R, D) int32, -1 padding
    w: np.ndarray     # (B, R, D) int32, 0 padding
    v0: np.ndarray    # (B,) int32 first local row of each chunk
    overflow: Tuple[Optional[Overflow], ...]

    @property
    def shape(self):
        return self.idx.shape


def build_move_chunks_dist(shards, num_chunks: int, p: int,
                           device=None) -> DistMoveChunks:
    """ELL twin of ``graphs.distribute.chunk_local_arcs`` for PE ``p``:
    its chunks' vertex spans (the arcs of one vertex never straddle a
    chunk), R the largest span rounded up to a power of two, the lane
    width capped as ``build_move_chunks`` caps it. Raises
    ``dispatch.EllTooLarge`` before it allocates when the build would not
    fit the host, or the card (``device``, CUDA)."""
    from ...graphs.distribute import chunk_local_arcs

    srcs, _, _ = chunk_local_arcs(shards, num_chunks)
    B, n_loc = srcs.shape[1], shards.n_loc
    spans = np.zeros((B, 2), dtype=np.int64)
    for b in range(B):
        sv = srcs[p, b][srcs[p, b] < n_loc]
        if sv.size:
            spans[b] = (int(sv.min()), int(sv.max()) + 1)
    R = lp._next_pow2(max(1, int((spans[:, 1] - spans[:, 0]).max())))
    indptr, adj, aw = local_csr(shards, p)
    deg = np.diff(indptr)
    D = slab_width(deg, B * R)
    slab, over, temp = split_bytes(deg, B * R, D, B)
    table = n_loc + shards.n_ghost + 1
    dispatch.check_ell_bytes("build_move_chunks_dist", (B, R, D),
                             slab + over + temp,
                             stacked_bytes(1, B, R, D, table) + 3 * over,
                             device)
    idx = np.full((B, R, D), -1, dtype=np.int32)
    w = np.zeros((B, R, D), dtype=np.int32)
    overflow = tuple(ell_rows(indptr, adj, aw, int(spans[b, 0]),
                              int(spans[b, 1]), idx[b], w[b])
                     if spans[b, 1] > spans[b, 0] else None
                     for b in range(B))
    return DistMoveChunks(idx=idx, w=w, v0=spans[:, 0].astype(np.int32),
                          overflow=overflow)


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
