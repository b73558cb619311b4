"""Initial partitioning of (small) coarsest graphs and block-induced
subgraphs (paper Algorithm 1, base case + LocalPartitioning).

The paper gathers the coarsest graph / the block-induced subgraphs on
single PEs and runs a *sequential* partitioner (KaMinPar / Mt-KaHyPar).
Our sequential partitioner is greedy graph growing + FM-lite refinement,
run with repetitions; graphs here are ~2C vertices so host numpy/heapq is
the right tool (matching the paper's design point exactly).
"""
from __future__ import annotations

import heapq
from typing import List, Tuple

import numpy as np

from ..graphs.format import Graph, induced_subgraph


def _neighbors(g: Graph, v: int) -> Tuple[np.ndarray, np.ndarray]:
    a0, a1 = int(g.indptr[v]), int(g.indptr[v + 1])
    return g.adjncy[a0:a1], g.eweights[a0:a1]


def ggg_bipartition(g: Graph, target1: int, lmax0: int, lmax1: int,
                    rng: np.random.Generator) -> np.ndarray:
    """Greedy graph growing: grow block 1 from a random seed by max gain
    until it reaches ``target1`` (and block 0 fits ``lmax0``)."""
    n = g.n
    part = np.zeros(n, dtype=np.int64)
    if n == 0:
        return part
    vw = g.vweights
    total = int(vw.sum())
    min_w1 = max(0, total - lmax0)
    # initial gains: joining an empty B1 loses all incident weight
    wdeg = np.zeros(n, dtype=np.int64)
    np.add.at(wdeg, g.arc_tails(), g.eweights)
    gain = -wdeg
    in1 = np.zeros(n, dtype=bool)
    heap: list = []
    seed = int(rng.integers(n))
    heapq.heappush(heap, (0, seed))
    gain[seed] = 0
    w1 = 0
    visited_push = np.zeros(n, dtype=bool)
    visited_push[seed] = True
    # iteration guard: when no remaining vertex fits lmax1 but min_w1 is
    # unreachable (overweight parent block), the grow loop cannot make
    # progress — bail out and let the balancer repair feasibility
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
            visited_push[v] = True
            continue
        negg, v = heapq.heappop(heap)
        if in1[v] or -negg != gain[v]:
            continue  # stale entry
        if w1 + int(vw[v]) > lmax1:
            continue
        in1[v] = True
        w1 += int(vw[v])
        nbr, nw = _neighbors(g, v)
        upd = nbr[~in1[nbr]]
        uw = nw[~in1[nbr]]
        gain[upd] += 2 * uw
        for u, _ in zip(upd.tolist(), uw.tolist()):
            heapq.heappush(heap, (-int(gain[u]), u))
            visited_push[u] = True
    part[in1] = 1
    return part


def fm_lite_refine(g: Graph, part: np.ndarray, lmax: np.ndarray,
                   rounds: int = 3) -> np.ndarray:
    """Greedy sequential 2-way refinement with live gain updates."""
    n = g.n
    if n == 0:
        return part
    part = part.copy()
    vw = g.vweights
    src = g.arc_tails()
    for _ in range(rounds):
        conn = np.zeros((n, 2), dtype=np.int64)
        np.add.at(conn, (src, part[g.adjncy]), g.eweights)
        own = conn[np.arange(n), part]
        oth = conn[np.arange(n), 1 - part]
        gains = oth - own
        bw = np.zeros(2, dtype=np.int64)
        np.add.at(bw, part, vw)
        order = np.argsort(-gains, kind="stable")
        moved = 0
        for v in order.tolist():
            gcur = conn[v, 1 - part[v]] - conn[v, part[v]]
            if gcur < 0:
                break
            t = 1 - part[v]
            if bw[t] + vw[v] > lmax[t]:
                continue
            if gcur == 0 and bw[t] + vw[v] >= bw[part[v]]:
                continue  # zero-gain only if it improves balance
            bw[part[v]] -= vw[v]
            bw[t] += vw[v]
            nbr, nw = _neighbors(g, v)
            conn[nbr, part[v]] -= nw
            conn[nbr, t] += nw
            part[v] = t
            moved += 1
        if moved == 0:
            break
    return part


def bipartition(g: Graph, k1: int, k2: int, l_max_final: int,
                rng: np.random.Generator, repetitions: int = 3
                ) -> np.ndarray:
    """Bipartition with target weights proportional to (k1, k2) final
    blocks; per-side budgets ki * L_max_final. Best of ``repetitions``."""
    total = int(g.vweights.sum())
    target1 = int(round(total * k2 / (k1 + k2)))
    lmax = np.asarray([k1 * l_max_final, k2 * l_max_final], dtype=np.int64)
    best, best_key = None, None
    for _ in range(max(1, repetitions)):
        part = ggg_bipartition(g, target1, int(lmax[0]), int(lmax[1]), rng)
        part = fm_lite_refine(g, part, lmax)
        bw = np.zeros(2, dtype=np.int64)
        np.add.at(bw, part, g.vweights)
        over = max(0, int(bw[0] - lmax[0])) + max(0, int(bw[1] - lmax[1]))
        cut_arcs = part[g.arc_tails()] != part[g.adjncy]
        cut = int(g.eweights[cut_arcs].sum()) // 2
        key = (over, cut)
        if best_key is None or key < best_key:
            best, best_key = part, key
    return best


def split_count(c: int) -> Tuple[int, int]:
    return (c + 1) // 2, c // 2


def distribute_counts(k: int, k0: int) -> List[int]:
    """Distribute k final blocks over k0 produced blocks (ceil/floor)."""
    base = k // k0
    extra = k % k0
    return [base + (1 if i < extra else 0) for i in range(k0)]


def partition_into_counts(g: Graph, counts: List[int], l_max_final: int,
                          rng: np.random.Generator, repetitions: int = 3
                          ) -> np.ndarray:
    """Partition ``g`` into ``len(counts)`` blocks where block i must hold
    ~counts[i] final blocks' worth of weight (budget counts[i]*L_max).
    Returns part (n,) with block ids in counts order."""
    n = g.n
    part = np.zeros(n, dtype=np.int64)
    if len(counts) <= 1 or n == 0:
        return part
    h = len(counts) // 2
    left, right = counts[:h], counts[h:]
    k1, k2 = sum(left), sum(right)
    half = bipartition(g, k1, k2, l_max_final, rng, repetitions)
    off = 0
    for side, sub_counts in ((0, left), (1, right)):
        mask = half == side
        if len(sub_counts) == 1:
            part[mask] = off
        else:
            sub, old_ids = induced_subgraph(g, mask)
            sp = partition_into_counts(sub, sub_counts, l_max_final, rng,
                                       repetitions)
            part[old_ids] = sp + off
        off += len(sub_counts)
    return part


def recursive_bisection(g: Graph, kb: int, l_max_final: int,
                        rng: np.random.Generator, repetitions: int = 3
                        ) -> np.ndarray:
    """Partition ``g`` into ``kb`` unit blocks via recursive bisection."""
    return partition_into_counts(g, [1] * kb, l_max_final, rng, repetitions)
