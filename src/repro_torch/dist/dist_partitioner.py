"""Distributed deep multilevel graph partitioning driver (paper Alg. 1) —
port of ``repro.dist.dist_partitioner`` onto ``torch.distributed``.

Mirrors ``core/deep_mgp.py``: while the graph is large it coarsens with
*distributed* LP clustering over graph shards; once the graph fits one
PE's budget it delegates to the single-process deep-MGP path (the paper's
own base case). Uncoarsening projects through the contraction maps and
runs distributed refinement + balancing per level, reusing the shards
built during coarsening.

Every rank of the process group calls ``dist_partition_impl`` with the
same arguments and runs the host code (distribution, host contraction,
the base case, the uncoarsening loop) itself; each rank keeps only its
own PE's slab on its device, and every rank returns the same assignment
and trace. Two ``PartitionerConfig`` knobs select the distributed memory
model: ``contraction`` ("host" | "sharded") and ``weights``
("replicated" | "owner"); ``balance`` ("host" | "dist") picks where the
exact balancer (and the coarsening loop's cluster-weight enforcement)
runs.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import metrics
from ..core.balance import rebalance
from ..core.coarsening import enforce_cluster_weights
from ..core.contraction import contract
from ..core.deep_mgp import (PartitionerConfig, check_k,
                             partition as sp_partition, trace_event,
                             uncoarsen_seed)
from ..graphs.distribute import GraphShards, distribute_graph
from ..graphs.format import Graph
from .collectives import PeGroup
from .dist_balance import dist_enforce_cluster_weights, dist_rebalance
from .dist_contraction import dist_contract
from .dist_lp import dist_cluster, dist_lp_refine, dist_ulp_refine, \
    resolve_pe


def dist_refine_and_balance(g: Graph,
                            part: np.ndarray,
                            l_max_vec: np.ndarray,
                            P: int,
                            num_iterations: int = 2,
                            num_chunks: int = 8,
                            seed: int = 0,
                            use_grid: bool = True,
                            pe: Optional[PeGroup] = None,
                            shards: Optional[GraphShards] = None,
                            weights: str = "replicated",
                            balance: str = "host",
                            kernel: str = "auto",
                            refine: str = "lp",
                            balance_stats: Optional[Dict] = None
                            ) -> np.ndarray:
    """Distributed BalanceAndRefine: sharded refinement (``refine``: the
    size-constrained LP, or the unconstrained search whose overloads the
    balancer repairs) followed by the exact balancer, on the host
    (``core.balance.rebalance``, on the rank's device) or over the level's
    shards (``balance="dist"``)."""
    from ..core.refinement import check_refine_mode
    check_refine_mode(refine)
    pe = resolve_pe(pe, P)
    part = np.asarray(part, dtype=np.int64)
    l_max_vec = np.asarray(l_max_vec, dtype=np.int64)
    if shards is None:
        shards = distribute_graph(g, P)
    refine_fn = dist_ulp_refine if refine == "unconstrained" \
        else dist_lp_refine
    part = refine_fn(shards, part, l_max_vec,
                     num_iterations=num_iterations, num_chunks=num_chunks,
                     seed=seed, use_grid=use_grid, pe=pe, weights=weights)
    if balance == "dist":
        return dist_rebalance(shards, part, l_max_vec, seed=seed + 1,
                              use_grid=use_grid, pe=pe, weights=weights,
                              kernel=kernel, stats=balance_stats)
    return rebalance(g, part, l_max_vec, seed=seed + 1, kernel=kernel,
                     stats=balance_stats, device=pe.device)


def dist_partition_impl(g: Graph,
                        k: int,
                        P: int,
                        cfg: Optional[PartitionerConfig] = None,
                        use_grid: bool = True,
                        pe: Optional[PeGroup] = None,
                        trace: Optional[List[Dict]] = None) -> np.ndarray:
    """Distributed deep multilevel k-way partition over P PEs, one rank
    each (``pe``, default the initialised default group).

    Returns (n,) int64 block ids satisfying the paper's relaxed balance
    constraint, on every rank. ``trace`` collects per-level
    size/cut/timing records, the reference's records."""
    cfg = (cfg or PartitionerConfig()).validate()
    check_k(k, "dist_partition")
    if P < 1:
        raise ValueError(f"dist_partition: P must be >= 1, got {P}")
    if k == 1 or g.n == 0:
        return np.zeros(g.n, dtype=np.int64)
    pe = resolve_pe(pe, P)
    dev = pe.device
    total_c = g.total_vweight
    l_final = metrics.l_max(total_c, k, cfg.epsilon,
                            int(g.vweights.max()) if g.n else 1)
    C, K = cfg.contraction_limit, cfg.initial_k

    # ---- distributed deep coarsening -----------------------------------
    # hierarchy rows carry the level's shards so uncoarsening reuses them
    hierarchy: List[Tuple[Graph, np.ndarray, GraphShards]] = []
    G = g
    shards: Optional[GraphShards] = None
    level = 0
    while G.n > C * min(k, K) and G.n >= 2 * P and level < cfg.max_levels:
        kprime = max(1, min(k, G.n // max(1, C)))
        W = max(1, int(cfg.epsilon * total_c / kprime))
        t0 = time.perf_counter()
        if shards is None:  # sharded contraction hands us the next level
            shards = distribute_graph(G, P)
        labels = dist_cluster(shards, W,
                              num_iterations=cfg.cluster_iterations,
                              num_chunks=cfg.num_chunks,
                              seed=cfg.seed + level, use_grid=use_grid,
                              pe=pe, weights=cfg.weights, kernel=cfg.kernel)
        if cfg.balance == "dist":
            labels = dist_enforce_cluster_weights(
                shards, labels, W, use_grid=use_grid, pe=pe)
        else:
            labels = enforce_cluster_weights(labels,
                                             np.asarray(G.vweights), W)
        if cfg.contraction == "sharded":
            res = dist_contract(shards, labels, use_grid=use_grid, pe=pe,
                                kernel=cfg.kernel)
            Gc, mapping, next_shards = res.graph, res.mapping, res.shards
            cstats = res.stats
        else:
            Gc, mapping = contract(G, labels, kernel=cfg.kernel, device=dev)
            next_shards, cstats = None, None
        if Gc.n >= G.n * cfg.min_shrink:
            # converged — coarsest distributed level reached; record the
            # discarded level so traces explain the early exit
            trace_event(trace, phase="dist-coarsen-converged", level=level,
                        n=G.n, m=G.m, coarse_n=Gc.n, W=W, P=P,
                        time_s=round(time.perf_counter() - t0, 6))
            break
        rec = dict(phase="dist-coarsen", level=level, n=G.n, m=G.m,
                   coarse_n=Gc.n, W=W, P=P, contraction=cfg.contraction,
                   weights=cfg.weights,
                   time_s=round(time.perf_counter() - t0, 6))
        if cstats is not None:
            rec.update(exchange_s=cstats["exchange_s"],
                       payload_bytes=cstats["payload_bytes"])
        trace_event(trace, **rec)
        hierarchy.append((G, mapping, shards))
        G, shards = Gc, next_shards
        level += 1

    # ---- base case: single-process deep MGP on the coarse graph --------
    part = sp_partition(G, k, cfg, trace=trace, device=dev)

    # ---- uncoarsening: project + distributed refine/balance ------------
    lvec = np.full(k, l_final, dtype=np.int64)
    for lvl, (Gf, mapping, fshards) in enumerate(reversed(hierarchy)):
        t0 = time.perf_counter()
        part = part[mapping]
        lvl_seed = uncoarsen_seed(cfg.seed, lvl, stream=1)
        bal_stats: Dict = {}
        part = dist_refine_and_balance(
            Gf, part, lvec, P, num_iterations=cfg.refine_iterations,
            num_chunks=cfg.num_chunks, seed=lvl_seed, use_grid=use_grid,
            pe=pe, shards=fshards, weights=cfg.weights,
            balance=cfg.balance, kernel=cfg.kernel, refine=cfg.refine,
            balance_stats=bal_stats)
        if trace is not None:
            rec = dict(phase="dist-uncoarsen", level=lvl, n=Gf.n,
                       m=Gf.m, blocks=k, P=P, seed=lvl_seed,
                       balance=cfg.balance,
                       balance_rounds=bal_stats.get("rounds"),
                       cut=metrics.edge_cut(Gf, part),
                       time_s=round(time.perf_counter() - t0, 6))
            if cfg.refine != "lp":
                # unconstrained tier: the balancer doubles as the
                # feasibility afterburner, so balance_rounds IS the
                # repair-round count
                from ..core.unconstrained import penalty_schedule
                rec.update(refine=cfg.refine,
                           penalty=penalty_schedule(cfg.refine_iterations),
                           repair_rounds=bal_stats.get("rounds"))
            trace_event(trace, **rec)
    return part
