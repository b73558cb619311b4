"""SchNet (Schütt et al., arXiv:1706.08566) — continuous-filter conv —
port of ``repro.models.gnn.schnet``.

Config: 3 interactions, d_hidden=64, 300 gaussian RBFs, cutoff 10 Å.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ...dist.sharding import NULL_CTX, ShardCtx
from ..common import ParamSpec, act_fn
from .common import (GraphBatch, cosine_cutoff, edge_vectors, gaussian_rbf,
                     graph_energy, scatter_sum)


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_species: int = 100


def build_specs(cfg: SchNetConfig) -> Dict[str, Any]:
    d, r = cfg.d_hidden, cfg.n_rbf
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.n_species, d), (None, "feat"),
                           init="embed", scale=1.0),
    }
    for i in range(cfg.n_interactions):
        specs.update({
            f"i{i}_fw0": ParamSpec((r, d), (None, "feat")),
            f"i{i}_fb0": ParamSpec((d,), ("feat",), init="zeros"),
            f"i{i}_fw1": ParamSpec((d, d), ("feat", "feat")),
            f"i{i}_fb1": ParamSpec((d,), ("feat",), init="zeros"),
            f"i{i}_in_w": ParamSpec((d, d), ("feat", "feat")),
            f"i{i}_out_w0": ParamSpec((d, d), ("feat", "feat")),
            f"i{i}_out_b0": ParamSpec((d,), ("feat",), init="zeros"),
            f"i{i}_out_w1": ParamSpec((d, d), ("feat", "feat")),
            f"i{i}_out_b1": ParamSpec((d,), ("feat",), init="zeros"),
        })
    specs.update({
        "ro_w0": ParamSpec((d, d // 2), ("feat", None)),
        "ro_b0": ParamSpec((d // 2,), (None,), init="zeros"),
        "ro_w1": ParamSpec((d // 2, 1), (None, None)),
        "ro_b1": ParamSpec((1,), (None,), init="zeros"),
    })
    return specs


def forward(params, batch: GraphBatch, cfg: SchNetConfig,
            ctx: ShardCtx = NULL_CTX):
    """Returns per-graph energies (n_graphs,)."""
    ssp = act_fn("ssp")
    N = batch.n_node
    x = params["embed"][batch.species.long()]               # (N, d)
    rij, d, emask = edge_vectors(batch)
    rbf = gaussian_rbf(d, cfg.n_rbf, cfg.cutoff)            # (E, R)
    rbf = ctx.constrain(rbf, "edges", None)
    fc = cosine_cutoff(d, cfg.cutoff) * emask               # (E,)
    snd, rcv = batch.senders.long(), batch.receivers.long()
    for i in range(cfg.n_interactions):
        w = ssp(rbf @ params[f"i{i}_fw0"] + params[f"i{i}_fb0"])
        w = (w @ params[f"i{i}_fw1"] + params[f"i{i}_fb1"]) * fc[:, None]
        h = x @ params[f"i{i}_in_w"]                        # atomwise
        msg = ctx.constrain(h[snd] * w, "edges", None)     # cfconv filter
        agg = ctx.constrain(scatter_sum(msg, rcv, N), "nodes", None)
        v = ssp(agg @ params[f"i{i}_out_w0"] + params[f"i{i}_out_b0"])
        v = v @ params[f"i{i}_out_w1"] + params[f"i{i}_out_b1"]
        x = ctx.constrain(x + v, "nodes", None)
    e_atom = ssp(x @ params["ro_w0"] + params["ro_b0"])
    e_atom = e_atom @ params["ro_w1"] + params["ro_b1"]      # (N, 1)
    return graph_energy(e_atom, batch)


def loss_fn(params, batch: GraphBatch, cfg: SchNetConfig,
            ctx: ShardCtx = NULL_CTX):
    energies = forward(params, batch, cfg, ctx)
    return torch.mean(torch.square(energies - batch.labels))
