"""Baseline partitioners the paper compares against — port of
``repro.core.baselines``:

  * ``single_level_lp`` — XtraPuLP-like: no multilevel; random balanced
    initial assignment + LP refinement + balancing.
  * ``plain_mgp`` — classic multilevel (ParMETIS/ParHIP-like): coarsen only
    down to C·k vertices, direct k-way initial partition, refine up.

Both run their per-level programs on ``device`` (the card by default,
``"cpu"`` on purpose) and make the reference's calls as it makes them,
``kernel`` knobs included.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..graphs.format import Graph
from ..kernels import dispatch
from . import metrics
from .coarsening import cluster
from .contraction import contract
from .deep_mgp import PartitionerConfig
from .initial_partition import recursive_bisection
from .refinement import balance_and_refine


def random_balanced(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Weight-aware round-robin over a random vertex order."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(g.n)
    part = np.empty(g.n, dtype=np.int64)
    # snake order over weight-sorted vertices: heavy ones spread first
    w = g.vweights[order]
    worder = np.argsort(-w, kind="stable")
    snake = np.arange(g.n) % (2 * k)
    snake = np.where(snake < k, snake, 2 * k - 1 - snake)
    part[order[worder]] = snake
    return part


def single_level_lp(g: Graph, k: int, eps: float = 0.03,
                    num_iterations: int = 5, seed: int = 0,
                    device=None) -> np.ndarray:
    device = dispatch.resolve_device(device)
    l_final = metrics.l_max(g.total_vweight, k,
                            eps, int(g.vweights.max()) if g.n else 1)
    part = random_balanced(g, k, seed)
    lv = np.full(k, l_final, dtype=np.int64)
    return balance_and_refine(g, part, lv, num_iterations=num_iterations,
                              seed=seed, device=device)


def plain_mgp(g: Graph, k: int, cfg: Optional[PartitionerConfig] = None,
              device=None) -> np.ndarray:
    cfg = cfg or PartitionerConfig()
    device = dispatch.resolve_device(device)
    rng = np.random.default_rng(cfg.seed)
    total_c = g.total_vweight
    max_c = int(g.vweights.max()) if g.n else 1
    l_final = metrics.l_max(total_c, k, cfg.epsilon, max_c)
    C = cfg.contraction_limit

    hierarchy = []
    G = g
    level = 0
    # plain MGP: contraction limit scales with k (coarsest has ~C*k vertices)
    while G.n > C * k and level < cfg.max_levels:
        kprime = max(1, min(k, G.n // max(1, C)))
        W = max(1, int(cfg.epsilon * total_c / kprime))
        labels = cluster(G, W, num_iterations=cfg.cluster_iterations,
                         num_chunks=cfg.num_chunks, seed=cfg.seed + level,
                         device=device)
        Gc, mapping = contract(G, labels, device=device)
        if Gc.n >= G.n * cfg.min_shrink:
            break
        hierarchy.append((G, mapping))
        G = Gc
        level += 1

    part = recursive_bisection(G, k, l_final, rng, cfg.ip_repetitions)
    lv = np.full(k, l_final, dtype=np.int64)
    part = balance_and_refine(G, part, lv,
                              num_iterations=cfg.refine_iterations,
                              num_chunks=cfg.num_chunks, seed=cfg.seed,
                              device=device)
    for (Gf, mapping) in reversed(hierarchy):
        part = part[mapping]
        part = balance_and_refine(Gf, part, lv,
                                  num_iterations=cfg.refine_iterations,
                                  num_chunks=cfg.num_chunks,
                                  seed=cfg.seed + Gf.n % 1000003,
                                  device=device)
    return part
