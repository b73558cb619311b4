"""DLRM table sharding via the partitioner: vertices = embedding tables
(weight = rows x dim = HBM cost), edges = co-lookup frequency from
sampled batches. The k-way balanced min-cut groups co-accessed tables on
the same shard, cutting cross-device fused-lookup traffic — port of
``repro.placement.dlrm_placement``."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core import metrics
from ..core.deep_mgp import partition
from ..core.partitioner import fast_config
from ..graphs.format import from_coo


def cooccurrence_graph(sparse_batches: np.ndarray, table_rows: np.ndarray):
    """sparse_batches: (B, F, bag) indices; co-occurrence = same-example
    joint lookups (all F fire each example for DLRM, so the weight is
    uniform unless bags are empty; real deployments would use per-feature
    activity)."""
    B, F, _ = sparse_batches.shape
    active = (sparse_batches >= 0).any(axis=2)           # (B, F)
    co = active.astype(np.int64).T @ active.astype(np.int64)
    np.fill_diagonal(co, 0)
    iu, ju = np.nonzero(np.triu(co))
    return from_coo(F, iu, ju, eweights=co[iu, ju],
                    vweights=np.maximum(table_rows, 1))


def plan(sparse_batches: np.ndarray, table_rows: np.ndarray,
         n_shards: int, epsilon: float = 0.1, seed: int = 0, device=None
         ) -> Dict:
    g = cooccurrence_graph(sparse_batches, table_rows)
    part = partition(g, n_shards,
                     fast_config(seed=seed, epsilon=epsilon,
                                 contraction_limit=8), device=device)
    return {
        "assignment": part,                     # table -> shard
        "cut": metrics.edge_cut(g, part),
        "imbalance": metrics.imbalance(g, part, n_shards),
        "feasible": metrics.is_feasible(g, part, n_shards, epsilon),
    }
