"""Synthetic ``GraphBatch`` builders — port of ``repro.launch.gnn_data``.

``build_gnn_batch`` draws the reference's batch from the same seed (an
rgg2d graph of ``n`` vertices and numpy draws in the reference's order),
so both packages get the same numbers; its tensors go on ``device``,
the card by default.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graphs import generators
from ..kernels.dispatch import resolve_device
from ..models.gnn.common import GraphBatch


def build_gnn_batch(arch_id: str, cfg, n: int = 400, seed: int = 0,
                    device=None) -> GraphBatch:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    g = generators.make("rgg2d", n, 8.0, seed=seed)
    snd = g.arc_tails().astype(np.int32)
    rcv = np.asarray(g.adjncy, dtype=np.int32)
    N = g.n + 1
    mask = np.arange(N) < g.n

    def dev(x):
        return torch.as_tensor(np.asarray(x), device=device)
    if arch_id == "gat-cora":
        feat = rng.standard_normal((N, cfg.d_in)).astype(np.float32)
        labels = rng.integers(0, cfg.n_classes, N)
        return GraphBatch(senders=dev(snd), receivers=dev(rcv), n_node=N,
                          node_feat=dev(feat), labels=dev(labels),
                          node_mask=dev(mask))
    pos = rng.standard_normal((N, 3)).astype(np.float32) * 2.0
    species = rng.integers(0, 10, N)
    kw = {}
    if arch_id == "dimenet":
        from ..models.gnn.dimenet import build_triplets
        kj, ji = build_triplets(snd, rcv, N, cap=6 * snd.shape[0])
        kw = dict(trip_kj=dev(kj), trip_ji=dev(ji))
    return GraphBatch(
        senders=dev(snd), receivers=dev(rcv), n_node=N,
        species=dev(species), positions=dev(pos),
        graph_id=torch.zeros(N, dtype=torch.int32, device=device),
        n_graphs=1,
        labels=dev(rng.standard_normal(1).astype(np.float32)),
        node_mask=dev(mask), **kw)
