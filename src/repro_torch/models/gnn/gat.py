"""GAT (Velickovic et al., arXiv:1710.10903) — SDDMM + edge softmax + SpMM
— port of ``repro.models.gnn.gat``.

gat-cora config: 2 layers, 8 hidden units, 8 heads, attn aggregator.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ...dist.sharding import NULL_CTX, ShardCtx
from ..common import ParamSpec, cross_entropy_loss
from .common import GraphBatch, edge_softmax, scatter_sum


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2


def build_specs(cfg: GATConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {}
    d_in = cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        d_out = cfg.n_classes if last else cfg.d_hidden
        heads = 1 if last else cfg.n_heads
        specs[f"l{i}_w"] = ParamSpec((d_in, heads, d_out),
                                     ("feat", "heads", None))
        specs[f"l{i}_asrc"] = ParamSpec((heads, d_out), ("heads", None),
                                        scale=0.1)
        specs[f"l{i}_adst"] = ParamSpec((heads, d_out), ("heads", None),
                                        scale=0.1)
        specs[f"l{i}_b"] = ParamSpec((heads * d_out,), (None,), init="zeros")
        d_in = heads * d_out if not last else d_out
    return specs


def forward(params, batch: GraphBatch, cfg: GATConfig,
            ctx: ShardCtx = NULL_CTX):
    x = batch.node_feat                                   # (N, F)
    N = batch.n_node
    snd, rcv = batch.senders.long(), batch.receivers.long()
    # sentinel edges are masked out of the softmax and the sum
    pad = (batch.senders >= N - 1)[:, None]
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        h = torch.einsum("nf,fhd->nhd", x, params[f"l{i}_w"])  # (N, H, D)
        h = ctx.constrain(h, "nodes", None, None)
        a_s = torch.sum(h * params[f"l{i}_asrc"], dim=-1)    # (N, H)
        a_d = torch.sum(h * params[f"l{i}_adst"], dim=-1)
        e = a_s[snd] + a_d[rcv]                              # (E, H)
        e = F.leaky_relu(e, cfg.negative_slope)
        e = ctx.constrain(e, "edges", None)
        e = torch.where(pad, torch.full((), -1e30, dtype=e.dtype,
                                        device=e.device), e)
        alpha = edge_softmax(e, rcv, N)                      # (E, H)
        msg = alpha[:, :, None] * h[snd]                     # (E, H, D)
        msg = ctx.constrain(msg, "edges", None, None)
        out = scatter_sum(msg.masked_fill_(pad[:, :, None], 0.0), rcv, N)
        out = ctx.constrain(out, "nodes", None, None)
        if last:
            x = torch.mean(out, dim=1) + params[f"l{i}_b"]
        else:
            x = F.elu(out.reshape(N, -1) + params[f"l{i}_b"])
    return x                                                 # (N, n_classes)


def loss_fn(params, batch: GraphBatch, cfg: GATConfig,
            ctx: ShardCtx = NULL_CTX):
    logits = forward(params, batch, cfg, ctx)
    mask = batch.node_mask if batch.node_mask is not None else \
        torch.ones(batch.n_node, dtype=torch.bool, device=logits.device)
    return cross_entropy_loss(logits, batch.labels, mask=mask.float())
