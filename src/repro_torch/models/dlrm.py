"""DLRM (Naumov et al., arXiv:1906.00091) — RM2-class config — port of
``repro.models.dlrm``.

13 dense features -> bottom MLP 13-512-256-64; 26 sparse features ->
EmbeddingBag lookups (sum-pooled multi-hot); dot-product feature
interaction; top MLP 512-512-256-1.

The embedding bag is the reference's own gather + sum over the stacked
tables, one batched gather for all tables (the reference's ``vmap``
over the table axis); it does not go through the ``embedding_bag``
kernel, which the reference's model never calls either. An index in
[-V, 0) counts from the end of its table, as ``jnp.take`` does; one
outside [-V, V) raises on the host before anything is gathered (the
reference's ``jnp.take`` fills such a row with NaN).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..dist.sharding import NULL_CTX, ShardCtx, contiguous_stride, \
    local_param, rowwise, shard_offset, to_placements
from .common import ParamSpec, has_values


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_table: int = 1_000_000
    bag_size: int = 1                   # multi-hot indices per feature
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.float32

    @property
    def n_interact(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def build_specs(cfg: DLRMConfig) -> Dict[str, Any]:
    specs: Dict[str, Any] = {
        # one stacked tensor for all tables: (n_tables, vocab, dim)
        "tables": ParamSpec((cfg.n_sparse, cfg.vocab_per_table,
                             cfg.embed_dim),
                            ("expert", "table", "table_dim"),
                            init="embed", scale=0.01, dtype=cfg.param_dtype),
    }
    dims = [cfg.n_dense] + list(cfg.bot_mlp)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"bot_w{i}"] = ParamSpec((a, b), (None, "mlp"),
                                       dtype=cfg.param_dtype)
        specs[f"bot_b{i}"] = ParamSpec((b,), ("mlp",), init="zeros",
                                       dtype=cfg.param_dtype)
    d_top_in = cfg.n_interact + cfg.bot_mlp[-1]
    dims = [d_top_in] + list(cfg.top_mlp)
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        specs[f"top_w{i}"] = ParamSpec((a, b), (None, "mlp"),
                                       dtype=cfg.param_dtype)
        specs[f"top_b{i}"] = ParamSpec((b,), ("mlp",), init="zeros",
                                       dtype=cfg.param_dtype)
    return specs


def _rows(vocab: int, idx):
    """``idx`` as row numbers of a table of ``vocab`` rows, negative
    ones counted from the end; raises if any lies outside [-V, V) (fake
    indices, which have no values, are not checked)."""
    idx = idx.long()
    if not has_values(idx):
        return torch.where(idx < 0, idx + vocab, idx)
    lo, hi = (int(v) for v in torch.aminmax(idx)) if idx.numel() else (0, 0)
    if lo < -vocab or hi >= vocab:
        raise ValueError(
            f"embedding_bag: indices span [{lo}, {hi}] for a table of "
            f"{vocab} rows; they must lie in [-{vocab}, {vocab})")
    return torch.where(idx < 0, idx + vocab, idx)


def embedding_bag(table, idx, weights=None, mode: str = "sum"):
    """table: (V, D); idx: (B, bag); -> (B, D). Sum/mean pooling via
    gather + reduce over the fixed-size bag dim."""
    rows = table[_rows(table.shape[0], idx)]          # (B, bag, D)
    if weights is not None:
        rows = rows * weights[..., None]
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / idx.shape[1]
    return out


def table_bags(tables, sparse, dtype):
    """All tables' bags at once: tables (T, V, D), sparse (B, T, bag)
    -> (B, T, D), table t's bag summed from table t's rows."""
    if isinstance(tables, DTensor):
        return _table_bags_split(tables, sparse, dtype)
    n_tab, vocab = tables.shape[0], tables.shape[1]
    rows = _rows(vocab, sparse)                                  # (B, T, bag)
    tab = torch.arange(n_tab, device=rows.device)[None, :, None]
    return tables[tab, rows].to(dtype).sum(dim=2)


def _table_bags_split(tables: DTensor, sparse, dtype) -> DTensor:
    """``table_bags`` of DTensor tables, without gathering them: each rank
    sums the rows its own shard holds (its tables, its vocab rows) for
    its own batch rows, and the vocab shards' partial bags add up."""
    mesh, nd = tables.device_mesh, tables.device_mesh.ndim
    T, V, D = tables.shape
    tp = tables.placements
    vocab = [m for m, p in enumerate(tp) if p.is_shard(1)]
    tabs = [m for m, p in enumerate(tp) if p.is_shard(0)]
    sp = sparse.placements if isinstance(sparse, DTensor) else \
        (Replicate(),) * nd
    rows = tuple(Shard(1) if m in tabs else Replicate() if m in vocab
                 else Shard(0) if p.is_shard(0) else Replicate()
                 for m, p in enumerate(sp))
    lay = tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate()
                for p in tp)
    batch = [m for m, p in enumerate(rows) if p.is_shard(0)]
    idx = _rows(V, to_placements(sparse, mesh, rows).to_local())
    local = local_param(tables, mesh, lay, batch)
    idx = idx - shard_offset(to_placements(tables, mesh, lay), 1)
    inside = (idx >= 0) & (idx < local.shape[1])
    tab = torch.arange(local.shape[0], device=idx.device)[None, :, None]
    got = local[tab, torch.clamp(idx, 0, local.shape[1] - 1)].to(dtype)
    got = torch.where(inside[..., None], got,
                      torch.zeros((), dtype=dtype, device=got.device))
    shape = (sparse.shape[0], T, D)
    return DTensor.from_local(got.sum(dim=2), mesh, tuple(
        Partial() if m in vocab else rows[m] for m in range(nd)),
        run_check=False, shape=shape, stride=contiguous_stride(shape))


def _interact(feats):
    """(B, F, D) features -> (B, F (F - 1) / 2): their pairwise dot
    products above the diagonal."""
    inter = torch.einsum("bnd,bmd->bnm", feats, feats)      # (B, F, F)
    iu, ju = torch.triu_indices(feats.shape[1], feats.shape[1], 1,
                                device=feats.device)
    return inter[:, iu, ju]


def _features_whole(x):
    """A DTensor's feature (last) dim gathered on every rank, its other
    splits kept: each layer's input whole, its output split as its
    weight's ``mlp`` columns are (a layer's product then needs no
    partial sum)."""
    if not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    return to_placements(x, x.device_mesh, tuple(
        Replicate() if p.is_partial() or p.is_shard(last) else p
        for p in x.placements))


def _mlp(params, prefix, n, x, final_act=None):
    for i in range(n):
        x = _features_whole(x) @ params[f"{prefix}_w{i}"] + \
            params[f"{prefix}_b{i}"]
        if i < n - 1:
            x = F.relu(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def forward(params, batch, cfg: DLRMConfig, ctx: ShardCtx = NULL_CTX):
    """batch: dense (B, 13) float, sparse (B, 26, bag) int.
    Returns logits (B,)."""
    dense, sparse = batch["dense"], batch["sparse"]
    cd = cfg.compute_dtype
    bot = _mlp(params, "bot", len(cfg.bot_mlp), dense.to(cd),
               final_act=F.relu)                            # (B, 64)
    bot = ctx.constrain(bot, "batch", None)
    emb = table_bags(params["tables"], sparse, cd)          # (B, 26, D)
    emb = ctx.constrain(emb, "batch", None, None)

    feats = torch.cat([bot[:, None, :], emb], dim=1)        # (B, 27, D)
    flat = rowwise(_interact, feats) if isinstance(feats, DTensor) \
        else _interact(feats)                               # (B, 351)
    top_in = torch.cat([flat, bot], dim=-1)
    logits = _mlp(params, "top", len(cfg.top_mlp), top_in)  # (B, 1)
    return logits[:, 0]


def loss_fn(params, batch, cfg: DLRMConfig, ctx: ShardCtx = NULL_CTX):
    logits = forward(params, batch, cfg, ctx)
    y = batch["labels"].float()
    z = logits.float()
    # stable BCE-with-logits
    loss = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return torch.mean(loss)


def largest(scores, k: int):
    """``lax.top_k``: the k largest, ties by the lower index (a stable
    descending sort; ``torch.topk`` orders ties otherwise)."""
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    return scores[order], order


def retrieval_score(params, batch, cfg: DLRMConfig,
                    ctx: ShardCtx = NULL_CTX, top_k: int = 100):
    """Retrieval-scoring path: one query (dense + sparse profile) against
    ``n_candidates`` precomputed candidate vectors — a single batched dot
    + top-k, never a loop."""
    dense, sparse = batch["dense"], batch["sparse"]          # (1, ...)
    cand = batch["candidates"]                               # (Nc, D)
    cd = cfg.compute_dtype
    bot = _mlp(params, "bot", len(cfg.bot_mlp), dense.to(cd),
               final_act=F.relu)
    emb = table_bags(params["tables"], sparse, cd)
    user = bot + emb.sum(dim=1)                              # (1, D)
    scores = (cand.to(cd) @ user[0]).float()                 # (Nc,)
    return largest(scores, top_k)
