"""Deep multilevel graph partitioning (paper Algorithm 1) — port of
``repro.core.deep_mgp``.

The level loop is host Python (dynamic level shapes) around per-level torch
programs on one ``device``: LP clustering (``lp_move`` kernel or torch
ops), contraction (``seg_merge`` kernel or numpy), host initial
partitioning, and refinement (size-constrained LP, or the unconstrained
tier with its afterburner) + the exact balancer (``bal_round`` kernels or
torch ops) during uncoarsening.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graphs.format import Graph, from_coo
from ..kernels import dispatch
from . import metrics
from .coarsening import cluster
from .contraction import contract
from .initial_partition import (bipartition, distribute_counts,
                                partition_into_counts, split_count)
from .refinement import balance_and_refine

log = logging.getLogger("repro_torch.deep_mgp")


@dataclasses.dataclass(frozen=True)
class PartitionerConfig:
    """dKaMinPar-Fast defaults (paper §6: C=2000, 3 LP iterations);
    the Strong preset uses C=5000 / 5 iterations."""
    contraction_limit: int = 2000          # C
    initial_k: int = 2                     # K (bipartitioning base case)
    epsilon: float = 0.03
    cluster_iterations: int = 3
    refine_iterations: int = 2
    num_chunks: int = 8
    ip_repetitions: int = 3
    max_levels: int = 64
    min_shrink: float = 0.95               # stop coarsening if n_c/n above
    seed: int = 0
    # distributed-backend knobs (ignored by the single-process partitioner):
    # where each level contracts, how cluster/block weight tables are
    # laid out across PEs, and where balancing runs during uncoarsening
    # and coarsening — see docs/DIST.md for the memory model
    contraction: str = "host"              # "host" | "sharded"
    weights: str = "replicated"            # "replicated" | "owner"
    balance: str = "host"                  # "host" | "dist"
    # hot-loop implementation: "auto" (fused on CUDA, composed elsewhere),
    # "fused" (CUDA kernels), "composed" (torch ops) — bit-identical
    # results either way
    kernel: str = "auto"
    # refinement algorithm for the main per-level passes: "lp" (paper §4
    # size-constrained LP) or "unconstrained" (Jet-style penalty-weighted
    # search + afterburner repair, better cuts for more refinement time).
    # The sibling-restricted extension pass always uses LP.
    refine: str = "lp"

    def validate(self) -> "PartitionerConfig":
        """Reject configurations that would only fail later as opaque
        shape errors. Returns self so callers can chain it."""
        if self.epsilon <= 0:
            raise ValueError(
                f"epsilon must be > 0, got {self.epsilon!r} (the balance "
                "constraint L_max is undefined for non-positive slack)")
        if self.initial_k < 1:
            raise ValueError(f"initial_k must be >= 1, got {self.initial_k}")
        if self.contraction_limit < self.initial_k:
            raise ValueError(
                f"contraction_limit ({self.contraction_limit}) must be >= "
                f"initial_k ({self.initial_k}); the coarsest graph must "
                "hold at least one vertex per initial block")
        if self.num_chunks < 1:
            raise ValueError(
                f"num_chunks must be >= 1, got {self.num_chunks}")
        if self.cluster_iterations < 1 or self.refine_iterations < 0:
            raise ValueError(
                "cluster_iterations must be >= 1 and refine_iterations "
                f">= 0, got {self.cluster_iterations}/"
                f"{self.refine_iterations}")
        if self.contraction not in ("host", "sharded"):
            raise ValueError(
                "contraction must be 'host' or 'sharded', "
                f"got {self.contraction!r}")
        if self.weights not in ("replicated", "owner"):
            raise ValueError(
                "weights must be 'replicated' or 'owner', "
                f"got {self.weights!r}")
        if self.balance not in ("host", "dist"):
            raise ValueError(
                f"balance must be 'host' or 'dist', got {self.balance!r}")
        dispatch.check_kernel_mode(self.kernel)
        from .refinement import check_refine_mode
        check_refine_mode(self.refine)
        return self


def check_k(k: int, where: str = "partition") -> None:
    """Shared guard: k must be a positive block count."""
    if k < 1:
        raise ValueError(f"{where}: k must be >= 1, got {k}")


def trace_event(trace: Optional[List[Dict]], **record) -> None:
    """Append one per-level record to ``trace`` (no-op when None)."""
    if trace is not None:
        trace.append(record)


def _refine_stats(cfg: "PartitionerConfig",
                  trace: Optional[List[Dict]]) -> Optional[Dict]:
    """A stats dict for ``balance_and_refine`` when the trace wants a
    ``refine-mode`` record; None keeps the default path allocation-free."""
    if trace is not None and cfg.refine != "lp":
        return {}
    return None


def _trace_refine_mode(trace: Optional[List[Dict]],
                       cfg: "PartitionerConfig", stage: str,
                       level: Optional[int],
                       stats: Optional[Dict]) -> None:
    """One ``refine-mode`` record per non-default refinement pass: the
    mode, the penalty schedule applied, and how many afterburner rounds
    the feasibility repair took."""
    if stats is None:
        return
    rec: Dict = dict(phase="refine-mode", stage=stage, mode=cfg.refine)
    if level is not None:
        rec["level"] = level
    rec.update(stats)
    trace_event(trace, **rec)


def ceil2(x: int) -> int:
    return 1 << max(0, (int(x) - 1)).bit_length()


def uncoarsen_seed(base_seed: int, lvl: int, stream: int = 0) -> int:
    """Per-level refinement/balancer seed during uncoarsening.

    Derived from the level *index*, never from the level's vertex count:
    the historical ``seed + n % 1000003`` collided whenever two hierarchy
    levels had equal n (possible near the min_shrink exit), correlating
    LP and balancer tie-breaking across levels. ``stream`` separates
    independent uncoarsening loops that share one base seed — the
    distributed partitioner (stream 1) delegates its base case to
    this one (stream 0), and both count levels from 0; the 500009 offset
    is not a multiple of the 1000003 level stride, so no (stream, lvl)
    pair collides with another."""
    return base_seed + stream * 500009 + (lvl + 1) * 1000003


def _l_vec(block_k: np.ndarray, l_final: int) -> np.ndarray:
    return block_k.astype(np.int64) * int(l_final)


def extract_block_subgraphs(g: Graph, part: np.ndarray, nb: int
                            ) -> Tuple[List[Graph], List[np.ndarray]]:
    """All block-induced subgraphs in one O(m log m) pass.

    Returns (graphs, old_ids) lists indexed by block."""
    counts = np.bincount(part, minlength=nb)
    starts = np.concatenate([[0], np.cumsum(counts)])
    order = np.argsort(part, kind="stable")      # vertices grouped by block
    local = np.empty(g.n, dtype=np.int64)
    local[order] = np.arange(g.n) - starts[part[order]]
    src = g.arc_tails()
    keep = part[src] == part[g.adjncy]
    ksrc, kdst, kw = src[keep], g.adjncy[keep], g.eweights[keep]
    kblk = part[ksrc]
    eorder = np.argsort(kblk, kind="stable")
    ksrc, kdst, kw, kblk = ksrc[eorder], kdst[eorder], kw[eorder], kblk[eorder]
    ecounts = np.bincount(kblk, minlength=nb)
    estarts = np.concatenate([[0], np.cumsum(ecounts)])
    graphs, ids = [], []
    for b in range(nb):
        v0, v1 = starts[b], starts[b + 1]
        e0, e1 = estarts[b], estarts[b + 1]
        old = order[v0:v1]
        sub = from_coo(int(counts[b]), local[ksrc[e0:e1]], local[kdst[e0:e1]],
                       eweights=kw[e0:e1], vweights=g.vweights[old],
                       symmetrize=False, dedup=False)
        graphs.append(sub)
        ids.append(old)
    return graphs, ids


def extend_partition(g: Graph, part: np.ndarray, block_k: np.ndarray,
                     k: int, l_final: int, cfg: PartitionerConfig,
                     rng: np.random.Generator, target_blocks: int,
                     device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Paper Algorithm 1 lines 13–18: while |Pi| < target, split every
    splittable block via (gathered) sequential bipartitioning, then refine
    restricted to siblings."""
    while block_k.shape[0] < target_blocks and np.any(block_k > 1):
        nb = block_k.shape[0]
        graphs, ids = extract_block_subgraphs(g, part, nb)
        new_part = np.empty(g.n, dtype=np.int64)
        new_counts: List[int] = []
        parent: List[int] = []
        off = 0
        for b in range(nb):
            if block_k[b] <= 1:
                new_part[ids[b]] = off
                new_counts.append(1)
                parent.append(b)
                off += 1
                continue
            k1, k2 = split_count(int(block_k[b]))
            half = bipartition(graphs[b], k1, k2, l_final, rng,
                               cfg.ip_repetitions)
            new_part[ids[b]] = off + half
            new_counts.extend([k1, k2])
            parent.extend([b, b])
            off += 2
        block_k = np.asarray(new_counts, dtype=np.int64)
        part = new_part
        # sibling-restricted refinement pass (cheap cleanup of the split)
        lv = _l_vec(block_k, l_final)
        part = balance_and_refine(g, part, lv,
                                  parent=np.asarray(parent, dtype=np.int64),
                                  num_iterations=1,
                                  num_chunks=cfg.num_chunks,
                                  seed=cfg.seed + off, kernel=cfg.kernel,
                                  device=device)
    return part, block_k


def level0_cluster_plan(g: Graph, k: int,
                        cfg: Optional[PartitionerConfig] = None
                        ) -> Optional[Dict]:
    """Parameters of the level-0 ``cluster`` call :func:`partition`
    would make for this input, or None when coarsening would not run
    (small graph, ``k == 1``, ``max_levels == 0`` — a hint would go
    unused). Pure function of the same inputs as :func:`partition`, so a
    batching layer can precompute level-0 labels out-of-band and pass
    them back via ``level0_labels`` with exact fidelity."""
    cfg = (cfg or PartitionerConfig()).validate()
    check_k(k, "deep_mgp.level0_cluster_plan")
    if k == 1 or g.n == 0 or cfg.max_levels < 1:
        return None
    C, K = cfg.contraction_limit, cfg.initial_k
    if not g.n > C * min(k, K):
        return None
    total_c = g.total_vweight
    kprime = max(1, min(k, g.n // max(1, C)))
    return {"W": max(1, int(cfg.epsilon * total_c / kprime)),
            "num_iterations": cfg.cluster_iterations,
            "num_chunks": cfg.num_chunks,
            "seed": cfg.seed}


def partition(g: Graph, k: int, cfg: Optional[PartitionerConfig] = None,
              trace: Optional[List[Dict]] = None,
              level0_labels: Optional[np.ndarray] = None,
              device=None) -> np.ndarray:
    """Deep multilevel k-way partition. Returns block ids (n,).

    ``trace``, when given, receives one dict per phase/level (sizes, cuts,
    wall times) — the structured log surfaced by ``repro.api``.

    ``level0_labels``, when given, replaces the level-0 ``cluster`` call
    with precomputed labels. The caller guarantees they equal what that
    call would return (use :func:`level0_cluster_plan` to reproduce its
    parameters) — this is how the serving tier's batched dispatch runs
    one stacked clustering program for many requests while keeping every
    result bit-identical to a solo run.

    ``device`` is where the per-level programs run: the CUDA device by
    default, ``"cpu"`` only when asked for.
    """
    cfg = (cfg or PartitionerConfig()).validate()
    check_k(k, "deep_mgp.partition")
    device = dispatch.resolve_device(device)
    if k == 1 or g.n == 0:
        return np.zeros(g.n, dtype=np.int64)
    rng = np.random.default_rng(cfg.seed)
    total_c = g.total_vweight
    max_c = int(g.vweights.max()) if g.n else 1
    l_final = metrics.l_max(total_c, k, cfg.epsilon, max_c)
    C, K = cfg.contraction_limit, cfg.initial_k

    # ---- deep coarsening (lines 6–8) -----------------------------------
    hierarchy: List[Tuple[Graph, np.ndarray]] = []
    G = g
    level = 0
    while G.n > C * min(k, K) and level < cfg.max_levels:
        kprime = max(1, min(k, G.n // max(1, C)))
        W = max(1, int(cfg.epsilon * total_c / kprime))
        t0 = time.perf_counter()
        if level == 0 and level0_labels is not None:
            labels = np.asarray(level0_labels)
            if labels.shape[0] != G.n:
                raise ValueError(
                    f"level0_labels has {labels.shape[0]} entries for a "
                    f"{G.n}-vertex graph")
        else:
            labels = cluster(G, W, num_iterations=cfg.cluster_iterations,
                             num_chunks=cfg.num_chunks, seed=cfg.seed + level,
                             kernel=cfg.kernel, device=device)
        Gc, mapping = contract(G, labels, kernel=cfg.kernel, device=device)
        log.info("level %d: n=%d -> n_c=%d (W=%d)", level, G.n, Gc.n, W)
        if Gc.n >= G.n * cfg.min_shrink:
            break  # converged — coarsest level reached
        trace_event(trace, phase="coarsen", level=level, n=G.n, m=G.m,
                    coarse_n=Gc.n, W=W,
                    time_s=round(time.perf_counter() - t0, 6))
        hierarchy.append((G, mapping))
        G = Gc
        level += 1

    # ---- initial partition of the coarsest graph (base case) -----------
    t0 = time.perf_counter()
    k0 = max(1, min(k, K))
    counts = distribute_counts(k, k0)
    part = partition_into_counts(G, counts, l_final, rng,
                                 cfg.ip_repetitions)
    block_k = np.asarray(counts, dtype=np.int64)
    ref_stats = _refine_stats(cfg, trace)
    part = balance_and_refine(G, part, _l_vec(block_k, l_final),
                              num_iterations=cfg.refine_iterations,
                              num_chunks=cfg.num_chunks, seed=cfg.seed,
                              kernel=cfg.kernel, refine=cfg.refine,
                              stats=ref_stats, device=device)
    if trace is not None:
        trace_event(trace, phase="initial", n=G.n, m=G.m,
                    blocks=int(block_k.shape[0]),
                    cut=metrics.edge_cut(G, part),
                    time_s=round(time.perf_counter() - t0, 6))
        _trace_refine_mode(trace, cfg, "initial", None, ref_stats)

    # ---- uncoarsening: project, extend, refine (lines 7–9, 13–18) ------
    for lvl, (Gf, mapping) in enumerate(reversed(hierarchy)):
        t0 = time.perf_counter()
        part = part[mapping]
        target = min(k, ceil2(max(1, Gf.n // max(1, C))))
        target = max(target, block_k.shape[0])
        part, block_k = extend_partition(Gf, part, block_k, k, l_final,
                                         cfg, rng, target, device=device)
        ref_stats = _refine_stats(cfg, trace)
        part = balance_and_refine(Gf, part, _l_vec(block_k, l_final),
                                  num_iterations=cfg.refine_iterations,
                                  num_chunks=cfg.num_chunks,
                                  seed=uncoarsen_seed(cfg.seed, lvl),
                                  kernel=cfg.kernel, refine=cfg.refine,
                                  stats=ref_stats, device=device)
        if trace is not None:
            trace_event(trace, phase="uncoarsen", level=lvl, n=Gf.n,
                        m=Gf.m, blocks=int(block_k.shape[0]),
                        cut=metrics.edge_cut(Gf, part),
                        time_s=round(time.perf_counter() - t0, 6))
            _trace_refine_mode(trace, cfg, "uncoarsen", lvl, ref_stats)

    # ---- final extension to exactly k blocks (omitted-case in Alg. 1) --
    t0 = time.perf_counter()
    part, block_k = extend_partition(g, part, block_k, k, l_final, cfg,
                                     rng, target_blocks=k, device=device)
    if block_k.shape[0] < k:  # blocks that cannot split further (tiny n)
        pad = k - block_k.shape[0]
        block_k = np.concatenate([block_k, np.ones(pad, dtype=np.int64)])
    ref_stats = _refine_stats(cfg, trace)
    part = balance_and_refine(g, part, np.full(k, l_final, dtype=np.int64),
                              num_iterations=cfg.refine_iterations,
                              num_chunks=cfg.num_chunks, seed=cfg.seed + 17,
                              kernel=cfg.kernel, refine=cfg.refine,
                              stats=ref_stats, device=device)
    if trace is not None:
        trace_event(trace, phase="final", n=g.n, m=g.m, blocks=k,
                    cut=metrics.edge_cut(g, part),
                    time_s=round(time.perf_counter() - t0, 6))
        _trace_refine_mode(trace, cfg, "final", None, ref_stats)
    return part
