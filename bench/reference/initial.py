"""Plain NumPy versions of the partitioner's host stages on small graphs:
the initial partition of the coarsest graph and the bisections that extend
a partition to more blocks (dKaMinPar, arXiv:2303.01417, Algorithm 1:
greedy graph growing with FM-style 2-way refinement, best of a few
repetitions, recursive over block counts), frozen here as the benchmark's
yardstick. They draw from the request's one random generator in the
published order, so a replay that starts from the same seed draws the same
numbers. Graphs are ``plain.CSR``.
"""
from __future__ import annotations

import heapq

import numpy as np

from .plain import CSR, arc_tails


def csr_of_arcs(n: int, src, dst, w, vweights) -> CSR:
    """A CSR of arcs already in both directions: stably ordered by tail,
    nothing merged or dropped."""
    src = np.asarray(src, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n))
    return CSR(indptr, np.asarray(dst)[order], np.asarray(w)[order],
               vweights)


def induced_subgraph(g: CSR, mask: np.ndarray):
    """``(sub, old_ids)``: the subgraph induced by ``mask``, its vertices
    numbered in the order of their old ids."""
    old = np.flatnonzero(mask)
    new = np.full(g.n, -1, dtype=np.int64)
    new[old] = np.arange(old.size)
    src = arc_tails(g.indptr)
    keep = mask[src] & mask[g.adjncy]
    return csr_of_arcs(old.size, new[src[keep]], new[g.adjncy[keep]],
                       g.eweights[keep], g.vweights[old]), old


def block_subgraphs(g: CSR, part: np.ndarray, nb: int):
    """``(graphs, old_ids)`` of every block's induced subgraph, a block's
    vertices in the order of their old ids."""
    counts = np.bincount(part, minlength=nb)
    starts = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(part, kind="stable")
    local = np.empty(g.n, dtype=np.int64)
    local[order] = np.arange(g.n) - starts[part[order]]
    src = arc_tails(g.indptr)
    keep = part[src] == part[g.adjncy]
    ksrc, kdst, kw = src[keep], g.adjncy[keep], g.eweights[keep]
    eorder = np.argsort(part[ksrc], kind="stable")
    ksrc, kdst, kw = ksrc[eorder], kdst[eorder], kw[eorder]
    estarts = np.concatenate(
        [[0], np.cumsum(np.bincount(part[ksrc], minlength=nb))])
    graphs, ids = [], []
    for b in range(nb):
        old = order[starts[b]:starts[b + 1]]
        e0, e1 = estarts[b], estarts[b + 1]
        graphs.append(csr_of_arcs(int(counts[b]), local[ksrc[e0:e1]],
                                  local[kdst[e0:e1]], kw[e0:e1],
                                  g.vweights[old]))
        ids.append(old)
    return graphs, ids


def grow(g: CSR, target1: int, lmax0: int, lmax1: int, rng) -> np.ndarray:
    """Greedy graph growing: block 1 grows from a random vertex, always by
    the vertex of highest gain, until it holds ``target1`` (and block 0
    fits ``lmax0``); a vertex that would overload block 1 is passed over,
    and when the frontier runs dry a random vertex that fits restarts it."""
    n = g.n
    part = np.zeros(n, dtype=np.int64)
    if n == 0:
        return part
    vw = g.vweights
    min_w1 = max(0, int(vw.sum()) - lmax0)
    gain = -np.bincount(arc_tails(g.indptr), weights=g.eweights,
                        minlength=n).astype(np.int64)
    in1 = np.zeros(n, dtype=bool)
    start = int(rng.integers(n))
    heap = [(0, start)]
    gain[start] = 0
    w1 = 0
    budget = 8 * n + 64
    while w1 < target1 or w1 < min_w1:
        budget -= 1
        if budget <= 0:
            break
        if not heap:
            rest = np.flatnonzero(~in1)
            if rest.size == 0:
                break
            fits = rest[vw[rest] + w1 <= lmax1]
            if fits.size == 0:
                break
            v = int(rng.choice(fits))
            heapq.heappush(heap, (-int(gain[v]), v))
            continue
        negg, v = heapq.heappop(heap)
        if in1[v] or -negg != gain[v] or w1 + int(vw[v]) > lmax1:
            continue
        in1[v] = True
        w1 += int(vw[v])
        a0, a1 = int(g.indptr[v]), int(g.indptr[v + 1])
        out = ~in1[g.adjncy[a0:a1]]
        nbr, nw = g.adjncy[a0:a1][out], g.eweights[a0:a1][out]
        gain[nbr] += 2 * nw
        for u in nbr.tolist():
            heapq.heappush(heap, (-int(gain[u]), u))
    part[in1] = 1
    return part


def fm_refine(g: CSR, part: np.ndarray, lmax: np.ndarray,
              rounds: int = 3) -> np.ndarray:
    """2-way refinement: in order of gain, a vertex of non-negative gain
    moves while the other side has room (a zero gain only towards the
    lighter side); gains update as vertices move."""
    n = g.n
    if n == 0:
        return part
    part = part.copy()
    vw = g.vweights
    src = arc_tails(g.indptr)
    rows = np.arange(n)
    for _ in range(rounds):
        conn = np.zeros((n, 2), dtype=np.int64)
        np.add.at(conn, (src, part[g.adjncy]), g.eweights)
        gains = conn[rows, 1 - part] - conn[rows, part]
        bw = np.bincount(part, weights=vw, minlength=2).astype(np.int64)
        moved = 0
        for v in np.argsort(-gains, kind="stable").tolist():
            s = part[v]
            t = 1 - s
            gv = conn[v, t] - conn[v, s]
            if gv < 0:
                break
            if bw[t] + vw[v] > lmax[t] or \
                    (gv == 0 and bw[t] + vw[v] >= bw[s]):
                continue
            bw[s] -= vw[v]
            bw[t] += vw[v]
            a0, a1 = int(g.indptr[v]), int(g.indptr[v + 1])
            conn[g.adjncy[a0:a1], s] -= g.eweights[a0:a1]
            conn[g.adjncy[a0:a1], t] += g.eweights[a0:a1]
            part[v] = t
            moved += 1
        if moved == 0:
            break
    return part


def bipartition(g: CSR, k1: int, k2: int, l_final: int, rng,
                repetitions: int) -> np.ndarray:
    """The best (least overload, then least cut) of ``repetitions`` grown
    and refined bisections into sides for k1 and k2 final blocks, each side
    within its count of L_max."""
    total = int(g.vweights.sum())
    target1 = int(round(total * k2 / (k1 + k2)))
    lmax = np.asarray([k1 * l_final, k2 * l_final], dtype=np.int64)
    src = arc_tails(g.indptr)
    best, best_key = None, None
    for _ in range(max(1, repetitions)):
        part = grow(g, target1, int(lmax[0]), int(lmax[1]), rng)
        part = fm_refine(g, part, lmax)
        bw = np.bincount(part, weights=g.vweights, minlength=2)
        over = max(0, int(bw[0] - lmax[0])) + max(0, int(bw[1] - lmax[1]))
        cut = int(g.eweights[part[src] != part[g.adjncy]].sum()) // 2
        if best_key is None or (over, cut) < best_key:
            best, best_key = part, (over, cut)
    return best


def split_count(c: int):
    return (c + 1) // 2, c // 2


def distribute_counts(k: int, k0: int) -> list:
    return [k // k0 + (1 if i < k % k0 else 0) for i in range(k0)]


def partition_into_counts(g: CSR, counts: list, l_final: int, rng,
                          repetitions: int) -> np.ndarray:
    """Recursive bisection into ``len(counts)`` blocks, block i sized for
    counts[i] final blocks; block ids in the order of ``counts``."""
    part = np.zeros(g.n, dtype=np.int64)
    if len(counts) <= 1 or g.n == 0:
        return part
    h = len(counts) // 2
    left, right = counts[:h], counts[h:]
    half = bipartition(g, sum(left), sum(right), l_final, rng, repetitions)
    off = 0
    for side, sub_counts in ((0, left), (1, right)):
        mask = half == side
        if len(sub_counts) == 1:
            part[mask] = off
        else:
            sub, old = induced_subgraph(g, mask)
            part[old] = off + partition_into_counts(sub, sub_counts,
                                                    l_final, rng,
                                                    repetitions)
        off += len(sub_counts)
    return part
