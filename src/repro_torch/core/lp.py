"""Size-constrained label propagation as torch ops (composed path).

Port of ``repro.core.lp``: the same chunked LP clustering and k-way
refinement steps, op for op, so labels and weights are bit-identical to
the JAX reference.

  gains:   sort arcs by (src, label[dst])  ->  per-(src,label) run lengths
           -> segment sum of arc weights   ->  per-src argmax with tie-breaks
  races:   optimistic moves + the paper's overweight revert (Section 4).

Where torch and JAX differ, the port spells out JAX's semantics:

  * ``lax.sort(num_keys=2)`` is a stable lexicographic sort; here one
    composite int64 key under a stable ``torch.sort``.
  * ``torch.cumsum`` and ``torch.sum`` widen int32 to int64; results are
    cast back to int32 (which wraps exactly as XLA's int32 does).
  * ``jax.ops.segment_max``/``segment_min`` give INT32_MIN/INT32_MAX for
    an empty segment; ``scatter_reduce`` starts from those identities
    with ``include_self=True``.
  * uint32 hashing runs in int64 with masks (torch cannot shift uint32
    on the CPU).

All device-side integers are int32; the host side guarantees total
vertex / edge weight < 2**31 (checked at build).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graphs.format import Graph

I32_MAX = int(np.iinfo(np.int32).max)
I32_MIN = int(np.iinfo(np.int32).min)
_MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host-side chunk construction (numpy, copied from the reference)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LPChunks:
    """Padded per-chunk arc slabs. Sentinel arcs: src = dst = n_pad, w = 0.

    ``n_pad`` and ``m_pad`` are rounded to powers of two, the reference's
    shape buckets, so every table has the reference's shape.
    """
    src: np.ndarray   # (B, m_pad) int32
    dst: np.ndarray   # (B, m_pad) int32
    w: np.ndarray     # (B, m_pad) int32
    n: int            # true vertex count
    n_pad: int        # padded (power-of-two) vertex count == sentinel id
    num_chunks: int


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1)).bit_length()


def chunk_bounds(g: Graph, num_chunks: int) -> list:
    """Chunk boundaries: contiguous vertex ranges with ~equal arc counts.
    Returns ``B + 1`` vertex ids; chunk ``b`` covers ``[bounds[b],
    bounds[b+1])``. Shared by the arc-slab (composed) and ELL (fused)
    chunk builders so both paths walk identical vertex ranges."""
    n, m = g.n, g.m
    B = max(1, min(num_chunks, max(1, n)))
    target = (m + B - 1) // max(B, 1) if m else 1
    bounds = [0]
    for b in range(1, B):
        v = int(np.searchsorted(g.indptr, b * target, side="left"))
        bounds.append(min(max(v, bounds[-1]), n))
    bounds.append(n)
    return bounds


def build_chunks(g: Graph, num_chunks: int, pad_shapes: bool = True) -> LPChunks:
    if g.total_eweight >= 2**31 or g.total_vweight >= 2**31:
        raise ValueError(
            f"build_chunks: total vertex/edge weight ({g.total_vweight}/"
            f"{g.total_eweight}) must be < 2^31 for the int32 device path")
    n, m = g.n, g.m
    n_pad = _next_pow2(n) if pad_shapes else n
    bounds = chunk_bounds(g, num_chunks)
    B = len(bounds) - 1
    src = g.arc_tails().astype(np.int64)
    m_pad = 1
    for b in range(B):
        a0, a1 = int(g.indptr[bounds[b]]), int(g.indptr[bounds[b + 1]])
        m_pad = max(m_pad, a1 - a0)
    if pad_shapes:
        m_pad = _next_pow2(m_pad)
    slabs = []
    for b in range(B):
        a0, a1 = int(g.indptr[bounds[b]]), int(g.indptr[bounds[b + 1]])
        cnt = a1 - a0
        s = np.full(m_pad, n_pad, dtype=np.int32)
        d = np.full(m_pad, n_pad, dtype=np.int32)
        ww = np.zeros(m_pad, dtype=np.int32)
        s[:cnt] = src[a0:a1]
        d[:cnt] = g.adjncy[a0:a1]
        ww[:cnt] = g.eweights[a0:a1]
        slabs.append((s, d, ww))
    return LPChunks(src=np.stack([x[0] for x in slabs]),
                    dst=np.stack([x[1] for x in slabs]),
                    w=np.stack([x[2] for x in slabs]),
                    n=n, n_pad=n_pad, num_chunks=B)


# ---------------------------------------------------------------------------
# int32 helpers with JAX semantics
# ---------------------------------------------------------------------------

def hash32(x: torch.Tensor, salt: int) -> torch.Tensor:
    """``core.lp._hash32`` bit for bit, in int64: the int32 input is
    reinterpreted as uint32 (-1 hashes as 0xFFFFFFFF), multiplied by
    2654435761 modulo 2^32, salted, mixed, masked to 31 bits."""
    x = x.to(torch.int64) & _MASK32
    # x * 2654435761 mod 2^32 without leaving int64: split the multiplier
    h = (x * 0x79B1 + (((x * 0x9E37) & 0xFFFF) << 16)) & _MASK32
    h = h ^ (int(salt) & _MASK32)
    h = h ^ (h >> 15)
    return (h & 0x7FFFFFFF).to(torch.int32)


def sort2(k1: torch.Tensor, k2: torch.Tensor, k2_bits: int = 32
          ) -> torch.Tensor:
    """Permutation of a stable lexicographic sort by (k1, k2): the
    ``lax.sort(num_keys=2)`` order. ``k1`` must be >= 0 and ``k2`` lie
    in [0, 2^k2_bits), so the composite int64 key cannot overflow."""
    key = (k1.to(torch.int64) << k2_bits) | k2.to(torch.int64)
    return torch.sort(key, stable=True).indices


def cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 0).to(torch.int32)


def segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    return torch.zeros(num, dtype=x.dtype, device=x.device).index_add_(
        0, seg, x)


def segment_max(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.full((num,), I32_MIN, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, reduce="amax", include_self=True)


def segment_min(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    out = torch.full((num,), I32_MAX, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, reduce="amin", include_self=True)


def chunk_salts(num_chunks: int, seed: int, mult: int) -> list:
    """The per-chunk uint32 salt stream ``arange(B) * mult + seed``."""
    return [(b * mult + int(seed)) % 2**32 for b in range(num_chunks)]


# ---------------------------------------------------------------------------
# gain machinery
# ---------------------------------------------------------------------------

def _group_conns(s_src, s_lab, s_w):
    """Per-arc connection weight of the (src, label) group the arc belongs
    to. Inputs must be sorted by (src, label)."""
    newgrp = torch.ones_like(s_src, dtype=torch.bool)
    newgrp[1:] = (s_src[1:] != s_src[:-1]) | (s_lab[1:] != s_lab[:-1])
    gid = (cumsum32(newgrp.to(torch.int32)) - 1).long()
    conn_g = segment_sum(s_w, gid, s_w.shape[0])
    return conn_g[gid]


def _argmax_target(s_src, s_lab, score, weight_key, salt, n):
    """Per-src argmax of ``score`` with ties broken by (lighter weight_key,
    then hash, then label). Returns (best_score, target_label) over n+1."""
    num = n + 1
    idx = s_src.long()
    best = segment_max(score, idx, num)
    is_best = score == best[idx]
    light = segment_min(torch.where(is_best, weight_key, I32_MAX), idx, num)
    is_best &= weight_key == light[idx]
    h = hash32(s_lab, salt)
    hbest = segment_min(torch.where(is_best, h, I32_MAX), idx, num)
    is_best &= h == hbest[idx]
    target = segment_min(torch.where(is_best, s_lab, I32_MAX), idx, num)
    return best, target


def _own_connection(s_src, s_lab, s_w, labels, n):
    idx = s_src.long()
    return segment_sum(torch.where(s_lab == labels[idx], s_w, 0), idx, n + 1)


def _sorted_slab(labels, chunk_src, chunk_dst, chunk_w):
    lab_dst = labels[chunk_dst.long()]
    order = sort2(chunk_src, lab_dst)
    return chunk_src[order], lab_dst[order], chunk_w[order]


# ---------------------------------------------------------------------------
# Clustering (coarsening) chunk step
# ---------------------------------------------------------------------------

def _cluster_chunk(labels, cluster_w, chunk_src, chunk_dst, chunk_w,
                   vweights, max_cluster_weight, salt, n):
    """One chunk of size-constrained LP clustering. Returns updated
    (labels, cluster_w)."""
    W = int(max_cluster_weight)
    s_src, s_lab, s_w = _sorted_slab(labels, chunk_src, chunk_dst, chunk_w)
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = _group_conns(s_src, s_lab, s_w)
    own_lab = labels[src_i]
    staying = s_lab == own_lab
    fits = ((cluster_w[lab_i] + vweights[src_i]) <= W) | staying
    score = torch.where(fits, conn, -1)
    best, target = _argmax_target(s_src, s_lab, score, cluster_w[lab_i],
                                  salt, n)
    own_conn = _own_connection(s_src, s_lab, s_w, labels, n)
    move = (best > own_conn) & (target != labels) & (target < I32_MAX) \
        & (best > 0)
    move[n] = False
    new_labels = torch.where(move, target, labels)
    vw_moved = torch.where(move, vweights, 0)
    num = n + 1
    d_in = segment_sum(vw_moved, new_labels.long(), num)
    d_out = segment_sum(vw_moved, labels.long(), num)
    new_cw = cluster_w + d_in - d_out

    # --- overweight revert (paper Section 4, Coarsening) -------------------
    over = new_cw > W
    cand = move & over[new_labels.long()]
    iota = torch.arange(num, dtype=torch.int32, device=labels.device)
    rk = hash32(iota, (int(salt) ^ 0x9E3779B9) & _MASK32)
    sort_lab = torch.where(cand, new_labels, num)
    order = sort2(sort_lab, rk, k2_bits=31)
    o_lab, o_v = sort_lab[order], iota[order]
    o_vw = torch.where(o_lab < num, vweights[o_v.long()], 0)
    csum = cumsum32(o_vw)
    grp_start = torch.ones_like(o_lab, dtype=torch.bool)
    grp_start[1:] = o_lab[1:] != o_lab[:-1]
    gid = (cumsum32(grp_start.to(torch.int32)) - 1).long()
    base = segment_min(torch.where(grp_start, csum - o_vw, I32_MAX), gid, num)
    within = csum - base[gid]
    lab_safe = torch.where(o_lab < num, o_lab, 0).long()
    allowed = torch.clamp(
        W - (new_cw[lab_safe] - segment_sum(o_vw, gid, num)[gid]), min=0)
    revert = (o_lab < num) & (within > allowed)
    rv = torch.zeros(num, dtype=torch.bool, device=labels.device)
    rv[o_v.long()] = revert
    rv &= move
    final_labels = torch.where(rv, labels, new_labels)
    vw_rv = torch.where(rv, vweights, 0)
    r_in = segment_sum(vw_rv, labels.long(), num)
    r_out = segment_sum(vw_rv, new_labels.long(), num)
    return final_labels, new_cw + r_in - r_out


def cluster_iteration(labels, cluster_w, chunks_src, chunks_dst, chunks_w,
                      vweights, max_cluster_weight, seed, *, n):
    """One full LP-clustering iteration over all chunks (int32 tensors on
    one device; ``seed`` the iteration's uint32 salt base)."""
    B = chunks_src.shape[0]
    for b, salt in enumerate(chunk_salts(B, seed, 0x85EBCA6B)):
        labels, cluster_w = _cluster_chunk(
            labels, cluster_w, chunks_src[b], chunks_dst[b], chunks_w[b],
            vweights, max_cluster_weight, salt, n)
    return labels, cluster_w


# ---------------------------------------------------------------------------
# k-way refinement chunk step
# ---------------------------------------------------------------------------

def _refine_chunk(labels, block_w, l_max, parent, chunk_src, chunk_dst,
                  chunk_w, vweights, salt, n, restricted):
    """One chunk of size-constrained LP refinement over k blocks.

    ``l_max`` is a per-block budget vector (k,). With ``restricted=True``
    moves are confined to blocks sharing a parent (the partition-extension
    step)."""
    s_src, s_lab, s_w = _sorted_slab(labels, chunk_src, chunk_dst, chunk_w)
    src_i, lab_i = s_src.long(), s_lab.long()
    conn = _group_conns(s_src, s_lab, s_w)
    own_lab = labels[src_i]
    staying = s_lab == own_lab
    # weight comparisons arranged as ``w <= budget - c`` so they cannot
    # wrap when the totals approach the int32 boundary
    fits = (block_w[lab_i] <= l_max[lab_i] - vweights[src_i]) & ~staying
    if restricted:
        fits &= parent[lab_i] == parent[own_lab.long()]
    score = torch.where(fits, conn, -1)
    best, target = _argmax_target(s_src, s_lab, score, block_w[lab_i],
                                  salt, n)
    own_conn = _own_connection(s_src, s_lab, s_w, labels, n)
    gain = best - own_conn
    tgt_safe = torch.where(target < I32_MAX, target, 0)
    # move on strict gain; zero-gain moves only if they strictly improve
    # balance (paper: ties broken in favor of the lighter block)
    lighter = block_w[tgt_safe.long()] < block_w[labels.long()] - vweights
    move = (target < I32_MAX) & (best >= 0) & \
        ((gain > 0) | ((gain == 0) & lighter))
    move[n] = False
    new_labels = torch.where(move, tgt_safe, labels)
    vw_moved = torch.where(move, vweights, 0)
    k = block_w.shape[0]
    d_in = segment_sum(vw_moved, torch.where(move, tgt_safe, 0).long(), k)
    d_out = segment_sum(vw_moved, torch.where(move, labels, 0).long(), k)
    return new_labels, block_w + d_in - d_out


def refine_iteration(labels, block_w, l_max, parent, chunks_src, chunks_dst,
                     chunks_w, vweights, seed, *, n, restricted=False):
    B = chunks_src.shape[0]
    for b, salt in enumerate(chunk_salts(B, seed, 0xC2B2AE35)):
        labels, block_w = _refine_chunk(
            labels, block_w, l_max, parent, chunks_src[b], chunks_dst[b],
            chunks_w[b], vweights, salt, n, restricted)
    return labels, block_w
