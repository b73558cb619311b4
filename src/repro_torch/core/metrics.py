"""Partition quality metrics (paper Section 2 definitions)."""
from __future__ import annotations

import numpy as np

from ..graphs.format import Graph


def edge_cut(g: Graph, part: np.ndarray) -> int:
    """Sum of weights of cut (undirected) edges."""
    src = g.arc_tails()
    cut_arcs = part[src] != part[g.adjncy]
    return int(g.eweights[cut_arcs].sum()) // 2


def block_weights(g: Graph, part: np.ndarray, k: int) -> np.ndarray:
    bw = np.zeros(k, dtype=np.int64)
    np.add.at(bw, part, g.vweights)
    return bw


def l_max(total_vweight: int, k: int, eps: float, max_vweight: int) -> int:
    """Paper balance constraint:
    L_max = max{(1+eps)·c(V)/k, c(V)/k + max_v c(v)} (relaxed variant)."""
    l1 = int(np.floor((1.0 + eps) * total_vweight / k))
    l2 = -(-total_vweight // k) + max_vweight
    return max(l1, l2)


def imbalance(g: Graph, part: np.ndarray, k: int) -> float:
    bw = block_weights(g, part, k)
    avg = g.total_vweight / k
    return float(bw.max() / avg - 1.0)


def is_feasible(g: Graph, part: np.ndarray, k: int, eps: float) -> bool:
    bw = block_weights(g, part, k)
    lim = l_max(g.total_vweight, k, eps, int(g.vweights.max()))
    return bool(bw.max() <= lim)


def summarize(g: Graph, part: np.ndarray, k: int, eps: float) -> dict:
    bw = block_weights(g, part, k)
    lim = l_max(g.total_vweight, k, eps, int(g.vweights.max()))
    return {
        "cut": edge_cut(g, part),
        "imbalance": imbalance(g, part, k),
        "max_block_weight": int(bw.max()),
        "min_block_weight": int(bw.min()),
        "l_max": lim,
        "feasible": bool(bw.max() <= lim),
        "k": k,
        "nonempty_blocks": int((bw > 0).sum()),
    }
