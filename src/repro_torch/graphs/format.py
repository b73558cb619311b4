"""Graph containers for the partitioner and GNN substrate.

Conventions (match the paper's input format, Section 2):
  * An undirected edge {u, v} is stored as two directed arcs (u, v) and (v, u).
  * Arcs are stored in CSR order (sorted by tail vertex).
  * Vertex weights ``c`` and edge weights ``w`` are positive integers
    (int64 accumulators so contracted weights never overflow).

The multilevel loop runs in host Python, so the canonical container is
numpy-backed; the per-level torch ops receive the raw arrays. This is the
port's own copy of ``repro.graphs.format`` (the port imports nothing of the
JAX package), so both packages read identical inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

INVALID = np.int32(-1)


@dataclasses.dataclass(frozen=True)
class Graph:
    """CSR graph with vertex/edge weights. ``m`` counts directed arcs."""

    indptr: np.ndarray      # (n+1,) int64
    adjncy: np.ndarray      # (m,)   int32/int64 — head vertex of each arc
    eweights: np.ndarray    # (m,)   int64
    vweights: np.ndarray    # (n,)   int64

    @property
    def n(self) -> int:
        return int(self.indptr.shape[0] - 1)

    @property
    def m(self) -> int:
        return int(self.adjncy.shape[0])

    @property
    def total_vweight(self) -> int:
        return int(self.vweights.sum())

    @property
    def total_eweight(self) -> int:
        return int(self.eweights.sum())

    def degrees(self) -> np.ndarray:
        return np.diff(self.indptr)

    def arc_tails(self) -> np.ndarray:
        """Expand CSR to COO tails: (m,) src vertex of each arc."""
        return np.repeat(np.arange(self.n, dtype=self.adjncy.dtype),
                         np.diff(self.indptr))

    def validate(self) -> None:
        n, m = self.n, self.m
        assert self.indptr[0] == 0 and self.indptr[-1] == m
        assert np.all(np.diff(self.indptr) >= 0)
        if m:
            assert self.adjncy.min() >= 0 and self.adjncy.max() < n
            assert self.eweights.min() >= 1
        assert np.all(self.vweights >= 1)
        # symmetry: every arc (u,v,w) must have a partner (v,u,w)
        src = self.arc_tails()
        fwd = np.lexsort((self.adjncy, src))
        bwd = np.lexsort((src, self.adjncy))
        assert np.array_equal(src[fwd], self.adjncy[bwd])
        assert np.array_equal(self.adjncy[fwd], src[bwd])
        assert np.array_equal(self.eweights[fwd], self.eweights[bwd])


def from_coo(n: int,
             src: np.ndarray,
             dst: np.ndarray,
             eweights: Optional[np.ndarray] = None,
             vweights: Optional[np.ndarray] = None,
             symmetrize: bool = True,
             dedup: bool = True) -> Graph:
    """Build a Graph from (possibly one-directional) COO arcs.

    Self loops are dropped; parallel arcs are merged by summing weights.
    """
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if eweights is None:
        eweights = np.ones_like(src, dtype=np.int64)
    else:
        eweights = np.asarray(eweights, dtype=np.int64)

    keep = src != dst
    src, dst, eweights = src[keep], dst[keep], eweights[keep]
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        eweights = np.concatenate([eweights, eweights])

    if dedup and src.size:
        key = src * n + dst
        order = np.argsort(key, kind="stable")
        key, src, dst, eweights = key[order], src[order], dst[order], eweights[order]
        first = np.concatenate([[True], key[1:] != key[:-1]])
        seg = np.cumsum(first) - 1
        merged_w = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
        np.add.at(merged_w, seg, eweights)
        src, dst, eweights = src[first], dst[first], merged_w
        if symmetrize:
            # a symmetrized + deduped arc list double-counts undirected weights
            # only if the input already contained both directions; from_coo
            # callers pass one direction, so weights are correct here.
            pass
    else:
        order = np.argsort(src, kind="stable")
        src, dst, eweights = src[order], dst[order], eweights[order]

    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n))
    if vweights is None:
        vweights = np.ones(n, dtype=np.int64)
    else:
        vweights = np.asarray(vweights, dtype=np.int64)
    g = Graph(indptr=indptr.astype(np.int64),
              adjncy=dst.astype(np.int32 if n < 2**31 else np.int64),
              eweights=eweights.astype(np.int64),
              vweights=vweights)
    return g


def permute(g: Graph, perm: np.ndarray) -> Tuple[Graph, np.ndarray]:
    """Relabel vertices: new id of old vertex v is perm[v]. Returns (graph, inv)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(g.n, dtype=perm.dtype)
    src = g.arc_tails()
    new_src = perm[src].astype(np.int64)
    new_dst = perm[g.adjncy].astype(np.int64)
    # the (new_src, new_dst) lexicographic order, as one stable sort of an
    # int64 key (exact for n < 2^31; several times faster than lexsort)
    order = np.argsort(new_src * g.n + new_dst, kind="stable")
    indptr = np.zeros(g.n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(new_src, minlength=g.n))
    g2 = Graph(indptr=indptr,
               adjncy=new_dst[order].astype(g.adjncy.dtype),
               eweights=g.eweights[order],
               vweights=g.vweights[inv])
    return g2, inv


def degree_bucket_order(g: Graph, rng: np.random.Generator,
                        chunk: int = 256) -> np.ndarray:
    """Paper §4 iteration order: exponentially spaced degree buckets,
    randomized inter-/intra-chunk. Returns a vertex traversal order."""
    deg = g.degrees()
    bucket = np.zeros(g.n, dtype=np.int64)
    nz = deg > 0
    bucket[nz] = np.floor(np.log2(deg[nz])).astype(np.int64) + 1
    # sort by bucket, random within bucket
    order = np.lexsort((rng.random(g.n), bucket))
    # chunk and shuffle chunks within each bucket
    out = []
    start = 0
    b_sorted = bucket[order]
    boundaries = np.flatnonzero(np.diff(b_sorted)) + 1
    for seg in np.split(order, boundaries):
        n_chunks = max(1, len(seg) // chunk)
        chunks = np.array_split(seg, n_chunks)
        idx = rng.permutation(len(chunks))
        for i in idx:
            c = chunks[i].copy()
            rng.shuffle(c)
            out.append(c)
        start += len(seg)
    return np.concatenate(out) if out else np.empty(0, dtype=np.int64)


def to_ell(g: Graph, max_degree: Optional[int] = None
           ) -> Tuple[np.ndarray, np.ndarray, int]:
    """ELL (padded row) format: (n, d) neighbor ids and weights.

    Rows longer than ``max_degree`` are truncated (callers that need
    exactness must check ``degrees().max()`` first). Padding uses
    ``n`` as a sentinel neighbor with weight 0.
    """
    deg = g.degrees()
    d = int(deg.max()) if deg.size else 0
    if max_degree is not None:
        d = min(d, max_degree)
    d = max(d, 1)
    idx = np.full((g.n, d), g.n, dtype=np.int64)
    wgt = np.zeros((g.n, d), dtype=np.int64)
    pos = np.minimum(np.arange(g.m) - np.repeat(g.indptr[:-1], deg), d - 1)
    rows = g.arc_tails()
    take = (np.arange(g.m) - g.indptr[rows]) < d
    idx[rows[take], pos[take]] = g.adjncy[take]
    wgt[rows[take], pos[take]] = g.eweights[take]
    return idx, wgt, d


def induced_subgraph(g: Graph, mask: np.ndarray
                     ) -> Tuple[Graph, np.ndarray]:
    """Subgraph induced by ``mask`` (bool over vertices).

    Returns (subgraph, old_ids) with old_ids[i] = original id of new vertex i.
    """
    old_ids = np.flatnonzero(mask)
    new_id = np.full(g.n, -1, dtype=np.int64)
    new_id[old_ids] = np.arange(old_ids.size)
    src = g.arc_tails()
    keep = mask[src] & mask[g.adjncy]
    sub = from_coo(old_ids.size, new_id[src[keep]], new_id[g.adjncy[keep]],
                   eweights=g.eweights[keep], vweights=g.vweights[old_ids],
                   symmetrize=False, dedup=False)
    return sub, old_ids
