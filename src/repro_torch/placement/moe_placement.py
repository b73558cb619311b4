"""MoE expert placement across pods: vertices = experts, edge weight =
top-k co-activation counts from router statistics. Partitioning into
#pods blocks puts frequently co-routed experts in the same pod, so a
token's experts usually live in one pod instead of crossing the
inter-pod link — port of ``repro.placement.moe_placement``. The counts
are host numpy (``np.add.at``), as in the reference."""
from __future__ import annotations

from typing import Dict

import numpy as np

from ..core import metrics
from ..core.deep_mgp import partition
from ..core.partitioner import fast_config
from ..graphs.format import from_coo


def coactivation_graph(topk_samples: np.ndarray, n_experts: int):
    """topk_samples: (T, k) expert ids per token."""
    T, k = topk_samples.shape
    co = np.zeros((n_experts, n_experts), dtype=np.int64)
    for a in range(k):
        for b in range(a + 1, k):
            np.add.at(co, (topk_samples[:, a], topk_samples[:, b]), 1)
    co = co + co.T
    np.fill_diagonal(co, 0)
    iu, ju = np.nonzero(np.triu(co))
    return from_coo(n_experts, iu, ju, eweights=co[iu, ju])


def plan(topk_samples: np.ndarray, n_experts: int, n_pods: int,
         epsilon: float = 0.0, seed: int = 0, device=None) -> Dict:
    g = coactivation_graph(topk_samples, n_experts)
    part = partition(g, n_pods,
                     fast_config(seed=seed, epsilon=max(epsilon, .01),
                                 contraction_limit=4), device=device)
    total = int(g.total_eweight) // 2
    cut = metrics.edge_cut(g, part)
    # naive baseline: contiguous expert ranges per pod
    naive = np.arange(n_experts) * n_pods // n_experts
    naive_cut = metrics.edge_cut(g, naive)
    return {
        "assignment": part,
        "cross_pod_fraction": cut / max(total, 1),
        "naive_cross_pod_fraction": naive_cut / max(total, 1),
        "experts_per_pod": np.bincount(part, minlength=n_pods).tolist(),
    }
