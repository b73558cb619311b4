"""The plain replay of one request to the single-device partitioner
(``backend="single"``), from the benchmark's own graph to the answer:
deep multilevel partitioning as dKaMinPar, arXiv:2303.01417, Algorithm 1
states it. Coarsen by size-constrained LP clustering and contraction
until the graph is small, partition the coarsest graph, then project the
partition level by level, extend it by bisections towards k blocks and
refine it, and finish with an extension to exactly k.

Every stage appends ``(kind, arrays)`` to ``stages`` in the order in which
the partitioner makes the same calls (``bench/stages/single.py`` records
the program's), so the first stage at which the two part ways shows.
"""
from __future__ import annotations

import importlib

import numpy as np

from . import initial, plain, refine_lp
from .check import l_max

# the presets' published settings (paper section 6: dKaMinPar-Fast uses
# C = 2000 and 3 LP iterations; dKaMinPar-Strong C = 5000 and 5)
PRESETS = {
    "fast": dict(contraction_limit=2000, cluster_iterations=3,
                 refine_iterations=2, ip_repetitions=3),
    "strong": dict(contraction_limit=5000, cluster_iterations=5,
                   refine_iterations=3, ip_repetitions=6),
}
COMMON = dict(initial_k=2, num_chunks=8, max_levels=64, min_shrink=0.95)


def settings(params: dict) -> dict:
    return dict(COMMON, **PRESETS[params["preset"]])


def ceil2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def uncoarsen_seed(seed: int, level: int) -> int:
    """The refinement seed of the level ``level`` steps up from the
    coarsest (a stride that no level count reaches twice)."""
    return seed + (level + 1) * 1000003


def graph_arrays(g) -> list:
    return [g.indptr, g.adjncy, g.eweights, g.vweights]


def partition(graph, params: dict, dev, stages: list) -> np.ndarray:
    """The answer to ``params`` (``k``, ``epsilon``, ``preset``, ``seed``,
    ``refine``) on ``graph`` (the four CSR arrays), on device ``dev``."""
    g = plain.CSR(*graph)
    k, eps, seed = int(params["k"]), float(params["epsilon"]), \
        int(params["seed"])
    s = settings(params)
    mode = importlib.import_module(
        f"{__package__}.refine_{params.get('refine', 'lp')}")
    if k == 1 or g.n == 0:
        return np.zeros(g.n, dtype=np.int64)
    rng = np.random.default_rng(seed)
    total = int(g.vweights.sum())
    l_final = l_max(total, k, eps, int(g.vweights.max()))
    C, K = s["contraction_limit"], s["initial_k"]

    def refine(G, part, lv, parent, iterations, rseed, refiner=mode):
        part = refiner.balance_and_refine(G, part, lv, parent, iterations,
                                          s["num_chunks"], rseed, dev)
        stages.append(("refine", [part]))
        return part

    def extend(G, part, block_k, target):
        """Split every block that stands for more than one final block by
        a bisection, then refine among siblings (by LP in every mode),
        until ``target`` blocks."""
        while block_k.shape[0] < target and np.any(block_k > 1):
            nb = block_k.shape[0]
            graphs, ids = initial.block_subgraphs(G, part, nb)
            new = np.empty(G.n, dtype=np.int64)
            counts, parent, off = [], [], 0
            for b in range(nb):
                if block_k[b] <= 1:
                    new[ids[b]] = off
                    counts.append(1)
                    parent.append(b)
                    off += 1
                    continue
                k1, k2 = initial.split_count(int(block_k[b]))
                new[ids[b]] = off + initial.bipartition(
                    graphs[b], k1, k2, l_final, rng, s["ip_repetitions"])
                counts.extend([k1, k2])
                parent.extend([b, b])
                off += 2
            block_k = np.asarray(counts, dtype=np.int64)
            part = refine(G, new, block_k * l_final,
                          np.asarray(parent, dtype=np.int64), 1, seed + off,
                          refine_lp)
        stages.append(("extend", [part]))
        return part, block_k

    # coarsening
    hierarchy = []
    G, level = g, 0
    while G.n > C * min(k, K) and level < s["max_levels"]:
        kprime = max(1, min(k, G.n // max(1, C)))
        W = max(1, int(eps * total / kprime))
        labels = plain.cluster(G, W, s["cluster_iterations"],
                               s["num_chunks"], seed + level, dev)
        stages.append(("cluster", [labels]))
        Gc, mapping = plain.contract(G, labels)
        stages.append(("contract", [mapping] + graph_arrays(Gc)))
        if Gc.n >= G.n * s["min_shrink"]:
            break
        hierarchy.append((G, mapping))
        G, level = Gc, level + 1

    # the coarsest graph's partition
    counts = initial.distribute_counts(k, max(1, min(k, K)))
    part = initial.partition_into_counts(G, counts, l_final, rng,
                                         s["ip_repetitions"])
    stages.append(("initial", [part]))
    block_k = np.asarray(counts, dtype=np.int64)
    part = refine(G, part, block_k * l_final, None, s["refine_iterations"],
                  seed)

    # uncoarsening
    for lvl, (Gf, mapping) in enumerate(reversed(hierarchy)):
        part = part[mapping]
        target = max(min(k, ceil2(max(1, Gf.n // max(1, C)))),
                     block_k.shape[0])
        part, block_k = extend(Gf, part, block_k, target)
        part = refine(Gf, part, block_k * l_final, None,
                      s["refine_iterations"], uncoarsen_seed(seed, lvl))

    part, block_k = extend(g, part, block_k, k)
    return refine(g, part, np.full(k, l_final, dtype=np.int64), None,
                  s["refine_iterations"], seed + 17)
