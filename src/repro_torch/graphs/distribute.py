"""1D vertex distribution with ghost vertices (paper §2 machine model) —
port of ``repro.graphs.distribute`` (numpy only, a copy).

Each PE owns a contiguous vertex range; arcs live with their tail; heads
owned by other PEs are *ghosts*. The halo plan precomputes, for every PE
pair (p, q), which of p's interface vertices q references — the static
send/recv schedule for label/feature halo exchanges.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .format import Graph


@dataclasses.dataclass(frozen=True)
class GraphShards:
    """Stacked per-PE arrays (leading axis = PE)."""
    P: int
    n: int                   # global vertex count
    n_loc: int               # padded local vertex slots per PE
    m_loc: int               # padded local arc slots per PE
    n_ghost: int             # padded ghost slots per PE
    halo_width: int          # padded per-peer halo message size S
    offsets: np.ndarray      # (P+1,) global range starts
    arc_src: np.ndarray      # (P, m_loc) int32 local tail (sentinel n_loc)
    arc_dst_idx: np.ndarray  # (P, m_loc) int32 index into label table
    arc_w: np.ndarray        # (P, m_loc) int32
    vweights: np.ndarray     # (P, n_loc) int32 (0-padded)
    local_gid: np.ndarray    # (P, n_loc) int32 global id (sentinel n)
    ghost_gid: np.ndarray    # (P, n_ghost) int32 global id (sentinel n)
    send_idx: np.ndarray     # (P, P, S) int32 local index to send (sent. n_loc)
    recv_slot: np.ndarray    # (P, P, S) int32 ghost slot of received value
                             #   (sentinel n_ghost = drop)

    @property
    def table_size(self) -> int:
        """Label-table length per PE: [locals | ghosts | sentinel]."""
        return self.n_loc + self.n_ghost + 1

    def comm_bytes_per_halo(self, itemsize: int = 4) -> int:
        """Real payload bytes moved per halo exchange (sum over PEs)."""
        return int((self.send_idx < self.n_loc).sum()) * itemsize


def balanced_offsets(g: Graph, P: int, by_arcs: bool = True) -> np.ndarray:
    """Contiguous 1D split balancing arc count (default) or vertex count."""
    if by_arcs and g.m > 0:
        targets = (np.arange(1, P) * g.m) // P
        cuts = np.searchsorted(g.indptr, targets, side="left")
    else:
        cuts = (np.arange(1, P) * g.n) // P
    offsets = np.concatenate([[0], cuts, [g.n]]).astype(np.int64)
    return np.maximum.accumulate(offsets)


def assemble_shards(n: int, offsets: np.ndarray,
                    arc_parts: List[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]],
                    vw_parts: List[np.ndarray]) -> GraphShards:
    """Build ``GraphShards`` from per-PE COO parts.

    PE p owns the contiguous global range [offsets[p], offsets[p+1]);
    ``arc_parts[p]`` is its (src_gid, dst_gid, w) arc triple (tails in
    p's range, sorted by tail) and ``vw_parts[p]`` its owned vertex
    weights. ``distribute_graph`` feeds this from CSR slices; the
    distributed contraction feeds it the owner-side coarse arcs so a
    coarse graph can enter the next level without a host CSR round-trip.
    """
    P = len(arc_parts)
    locals_per_pe: List[Tuple[int, int]] = [
        (int(offsets[p]), int(offsets[p + 1])) for p in range(P)]
    n_loc = max(1, max(v1 - v0 for v0, v1 in locals_per_pe))

    ghost_lists: List[np.ndarray] = []
    for p, (v0, v1) in enumerate(locals_per_pe):
        d = arc_parts[p][1]
        ghost_lists.append(np.unique(d[(d < v0) | (d >= v1)]))
    n_ghost = max(1, max(gl.size for gl in ghost_lists))
    m_loc = max(1, max(a[0].size for a in arc_parts))

    # halo width: p sends to q the vertices in q's ghost list ∩ p's range
    S = 1
    send_lists = [[None] * P for _ in range(P)]
    for q in range(P):
        gl = ghost_lists[q]
        own = np.searchsorted(offsets, gl, side="right") - 1
        for p in range(P):
            sl = gl[own == p]
            send_lists[p][q] = sl          # sorted (gl sorted)
            S = max(S, sl.size)

    arc_src = np.full((P, m_loc), n_loc, dtype=np.int32)
    arc_dst_idx = np.full((P, m_loc), n_loc + n_ghost, dtype=np.int32)
    arc_w = np.zeros((P, m_loc), dtype=np.int32)
    vweights = np.zeros((P, n_loc), dtype=np.int32)
    local_gid = np.full((P, n_loc), n, dtype=np.int32)
    ghost_gid = np.full((P, n_ghost), n, dtype=np.int32)
    send_idx = np.full((P, P, S), n_loc, dtype=np.int32)
    recv_slot = np.full((P, P, S), n_ghost, dtype=np.int32)

    for p, (v0, v1) in enumerate(locals_per_pe):
        cnt_v = v1 - v0
        s, d, w = arc_parts[p]
        cnt_a = s.size
        gl = ghost_lists[p]
        arc_src[p, :cnt_a] = s - v0
        d = d.astype(np.int64)
        is_local = (d >= v0) & (d < v1)
        idx = np.empty(cnt_a, dtype=np.int64)
        idx[is_local] = d[is_local] - v0
        idx[~is_local] = n_loc + np.searchsorted(gl, d[~is_local])
        arc_dst_idx[p, :cnt_a] = idx
        arc_w[p, :cnt_a] = w
        vweights[p, :cnt_v] = vw_parts[p]
        local_gid[p, :cnt_v] = np.arange(v0, v1)
        ghost_gid[p, :gl.size] = gl
        for q in range(P):
            sl = send_lists[p][q]
            send_idx[p, q, :sl.size] = sl - v0
            # on q's side, the message from p lands at q's ghost slots for sl
            recv_slot[q, p, :sl.size] = np.searchsorted(ghost_lists[q], sl)

    return GraphShards(P=P, n=n, n_loc=n_loc, m_loc=m_loc, n_ghost=n_ghost,
                       halo_width=S, offsets=offsets, arc_src=arc_src,
                       arc_dst_idx=arc_dst_idx, arc_w=arc_w,
                       vweights=vweights, local_gid=local_gid,
                       ghost_gid=ghost_gid, send_idx=send_idx,
                       recv_slot=recv_slot)


def distribute_graph(g: Graph, P: int, by_arcs: bool = True) -> GraphShards:
    return shards_at_offsets(g, balanced_offsets(g, P, by_arcs))


def shards_at_offsets(g: Graph, offsets: np.ndarray) -> GraphShards:
    """``distribute_graph`` over given block boundaries: PE p owns
    [offsets[p], offsets[p+1]) (the placement engine's blocks)."""
    P = offsets.shape[0] - 1
    src = g.arc_tails()
    arc_parts, vw_parts = [], []
    for p in range(P):
        v0, v1 = int(offsets[p]), int(offsets[p + 1])
        a0, a1 = int(g.indptr[v0]), int(g.indptr[v1])
        arc_parts.append((src[a0:a1], g.adjncy[a0:a1], g.eweights[a0:a1]))
        vw_parts.append(g.vweights[v0:v1])
    return assemble_shards(g.n, offsets, arc_parts, vw_parts)


def chunk_local_arcs(shards: GraphShards, num_chunks: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split each PE's arc slab into ``num_chunks`` equal static slices
    aligned on src-vertex boundaries (arcs of one vertex never straddle a
    chunk). Returns (P, B, m_chunk) slabs for (src, dst_idx, w)."""
    P, B = shards.P, num_chunks
    tgt = -(-shards.m_loc // B)
    all_bounds = []
    m_chunk = 1
    for p in range(P):
        valid = shards.arc_src[p] < shards.n_loc
        cnt = int(valid.sum())
        bounds = [0]
        asrc = shards.arc_src[p]
        for b in range(1, B):
            pos = min(b * tgt, cnt)
            # advance to the next src boundary so a vertex's arcs stay whole
            while 0 < pos < cnt and asrc[pos] == asrc[pos - 1]:
                pos += 1
            bounds.append(max(pos, bounds[-1]))
        bounds.append(cnt)
        all_bounds.append(bounds)
        m_chunk = max(m_chunk, max(bounds[b + 1] - bounds[b]
                                   for b in range(B)))
    srcs = np.full((P, B, m_chunk), shards.n_loc, dtype=np.int32)
    dsts = np.full((P, B, m_chunk), shards.n_loc + shards.n_ghost,
                   dtype=np.int32)
    ws = np.zeros((P, B, m_chunk), dtype=np.int32)
    for p in range(P):
        bounds = all_bounds[p]
        for b in range(B):
            x0, x1 = bounds[b], bounds[b + 1]
            take = x1 - x0
            srcs[p, b, :take] = shards.arc_src[p, x0:x1]
            dsts[p, b, :take] = shards.arc_dst_idx[p, x0:x1]
            ws[p, b, :take] = shards.arc_w[p, x0:x1]
    return srcs, dsts, ws
