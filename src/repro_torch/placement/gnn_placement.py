"""GNN node placement: partition the input graph into #devices blocks so
that the halo-exchange payload (== edge cut, paper's objective) shrinks;
relabel vertices block-contiguously so the 1D-range machine model of
graphs/distribute.py applies unchanged — port of
``repro.placement.gnn_placement``.

The blocks' shards are built from explicit offsets
(``distribute.shards_at_offsets``); the reference swaps a module global
of ``distribute`` for the call instead, which two threads placing at
once would race on.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core import metrics
from ..core.deep_mgp import partition
from ..core.partitioner import PartitionerConfig, fast_config
from ..graphs.distribute import distribute_graph, shards_at_offsets
from ..graphs.format import Graph, permute


@dataclasses.dataclass(frozen=True)
class GNNPlacement:
    graph: Graph              # vertex-relabelled (block-contiguous)
    perm: np.ndarray          # old id -> new id
    offsets: np.ndarray       # (P+1,) block boundaries
    cut: int
    halo_bytes: int           # per full halo exchange (sum over PEs)
    baseline_halo_bytes: int  # naive contiguous 1D split of the input


def plan(g: Graph, n_devices: int,
         config: Optional[PartitionerConfig] = None,
         epsilon: float = 0.03, seed: int = 0, device=None) -> GNNPlacement:
    cfg = config or fast_config(seed=seed, epsilon=epsilon)
    part = partition(g, n_devices, cfg, device=device)
    order = np.argsort(part, kind="stable")
    perm = np.empty(g.n, dtype=np.int64)
    perm[order] = np.arange(g.n)
    g2, _ = permute(g, perm)
    counts = np.bincount(part, minlength=n_devices)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    shards = shards_at_offsets(g2, offsets)
    base = distribute_graph(g, n_devices)   # naive contiguous split
    return GNNPlacement(graph=g2, perm=perm, offsets=offsets,
                        cut=metrics.edge_cut(g, part),
                        halo_bytes=shards.comm_bytes_per_halo(),
                        baseline_halo_bytes=base.comm_bytes_per_halo())
