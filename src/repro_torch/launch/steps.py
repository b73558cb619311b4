"""Step builders — port of ``repro.launch.steps``: (ArchEntry, ShapeSpec,
mesh) -> step function + abstract inputs + input shardings, for every
(arch x shape) cell of the registry. ``dryrun.py`` runs them on fake
tensors; tests and ``chip_smoke.py`` run them on real DTensors.

``args`` are fake tensors (no storage) of the reference's shapes and
dtypes, made in one ``FakeTensorMode`` a step (``BuiltStep.fake_mode``),
on the mesh's device type. ``in_shardings`` are trees of spec tuples in
the structure of ``args``: the reference's ``NamedSharding`` trees, with
a ``PartitionSpec`` as a tuple (``()`` replicates). The optimizer, the
microbatch count, ``accum_dtype`` and the analytic ``model_flops`` are
the reference's, each formula in the reference's operation order.

``mesh`` is a ``DeviceMesh`` or any mesh ``dist.sharding`` reads (a
``MeshShape`` gives the shardings and arguments of a mesh that has no
ranks; its step refuses to split). A step's ``fn`` runs under
``implicit_replication``: the plain tensors a model makes (positions,
masks, zeros) are the same on every rank and join DTensors as
replicated.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor.experimental import implicit_replication

from ..configs import ArchEntry, ShapeSpec
from ..dist.sharding import DEFAULT_RULES, ShardCtx, resolve_axes, \
    spec_shardings
from ..models import dlrm as DL
from ..models import transformer as T
from ..models.common import abstract_params, param_count, tree_map_specs
from ..models.gnn import dimenet as DN
from ..models.gnn import gat as GT
from ..models.gnn import nequip as NQ
from ..models.gnn import schnet as SN
from ..models.gnn.common import GraphBatch
from ..train.optimizer import OptConfig
from ..train.trainer import make_train_step

GNN_MODULES = {"gat-cora": GT, "schnet": SN, "nequip": NQ, "dimenet": DN}


@dataclasses.dataclass
class BuiltStep:
    name: str
    fn: Callable
    args: Tuple            # fake-tensor args
    in_shardings: Tuple    # spec-tuple trees, the structure of args
    model_flops: float     # analytic MODEL_FLOPS for §Roofline
    opt_name: str = ""
    fake_mode: Any = None  # the FakeTensorMode that made args


class _Abstract:
    """Fake tensors of one step, all in one mode, on ``device``."""

    def __init__(self, device):
        # a model's module constants (nequip's Levi-Civita tensor) are
        # real tensors: they join the fake ones as constants
        self.mode = FakeTensorMode(allow_non_fake_inputs=True)
        self.device = device

    def sds(self, shape, dtype):
        with self.mode:
            return torch.empty(tuple(shape), dtype=dtype,
                               device=self.device)

    def params(self, specs):
        return abstract_params(specs, self.mode, self.device)


def _device_of(mesh) -> str:
    return mesh.device_type if isinstance(mesh, DeviceMesh) else "cpu"


def _repl(mesh):
    return ()


def _shard_like(mesh, shape, *axes):
    return resolve_axes(shape, axes, mesh, DEFAULT_RULES)


def _replicating(fn):
    """``fn`` run under ``implicit_replication``."""
    @functools.wraps(fn)
    def run(*args, **kw):
        with implicit_replication():
            return fn(*args, **kw)
    return run


def _opt_shardings(opt_name: str, specs, param_sh, mesh,
                   min_dim_factored: int = 128):
    if opt_name == "adamw":
        return {"m": param_sh, "v": param_sh,
                "step": _repl(mesh)}

    # adafactor: factored slots drop one dim — shard with the remaining
    # logical axes of the ParamSpec (a replicated vr for a 480B MoE stack
    # is ~1 GB/device of waste)
    def one(s):
        if len(s.shape) >= 2 and s.shape[-1] >= min_dim_factored \
                and s.shape[-2] >= min_dim_factored:
            return {"vr": _shard_like(mesh, s.shape[:-1], *s.axes[:-1]),
                    "vc": _shard_like(mesh, s.shape[:-2] + s.shape[-1:],
                                      *(s.axes[:-2] + s.axes[-1:]))}
        return {"v": _shard_like(mesh, s.shape, *s.axes)}
    slots = tree_map_specs(one, specs)
    return {"slots": slots, "step": _repl(mesh)}


def _state_pack(ab: _Abstract, mesh, specs, loss, opt_name: str,
                microbatches: int = 1, accum_dtype=None):
    opt_cfg = OptConfig(name=opt_name, lr=1e-3)
    init_state, train_step = make_train_step(loss, opt_cfg,
                                             microbatches=microbatches,
                                             accum_dtype=accum_dtype)
    params_abs = ab.params(specs)
    with ab.mode:
        state_abs = init_state(params_abs)
    param_sh = spec_shardings(specs, mesh)
    state_sh = {"params": param_sh,
                "opt": _opt_shardings(opt_name, specs, param_sh, mesh),
                "step": _repl(mesh), "nan_skips": _repl(mesh)}
    return _replicating(train_step), state_abs, state_sh


# ---------------------------------------------------------------------------
# LM steps
# ---------------------------------------------------------------------------

def _lm_model_flops(cfg: T.TransformerConfig, tokens: int,
                    decode: bool = False, ctx_len: int = 0) -> float:
    """6·N_active·D (+ attention KV term for decode)."""
    d, L = cfg.d_model, cfg.n_layers
    ffn_mult = 3 if cfg.glu else 2
    dense = ffn_mult * d * cfg.d_ff if (cfg.moe_dense_residual or
                                        not cfg.moe) else 0
    moe = ffn_mult * d * cfg.expert_ff * cfg.top_k if cfg.moe else 0
    n_active = L * (d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
                    + dense + moe) + 2 * cfg.vocab * d
    flops = 6.0 * n_active * tokens
    if decode:
        # attention reads: 2 * L * ctx * (q_dim + ...) MACs per token
        flops += tokens * L * 4.0 * ctx_len * cfg.kv_dim \
            * (cfg.n_heads // cfg.n_kv_heads + 1)
    return flops


def build_lm_train(entry: ArchEntry, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg: T.TransformerConfig = entry.config
    B, S = shape.params["global_batch"], shape.params["seq_len"]
    ab = _Abstract(_device_of(mesh))
    ctx = ShardCtx(mesh)
    specs = T.build_specs(cfg)
    n_params = param_count(specs)
    big = n_params > 5e9
    opt_name = "adafactor" if big else "adamw"
    # gradient accumulation keeps activation transients inside HBM
    # (EXPERIMENTS.md §Perf); FSDP-sharded f32 accumulators are cheap
    accum_dtype = None
    if n_params > 1e11:
        microbatches = 8
        accum_dtype = torch.bfloat16   # halves the FSDP accumulator slab
    elif n_params > 1e9 or B * S > 2**21:
        microbatches = 2
    else:
        microbatches = 1
    loss = lambda p, b: T.loss_fn(p, b, cfg, ctx)  # noqa: E731
    train_step, state_abs, state_sh = _state_pack(
        ab, mesh, specs, loss, opt_name, microbatches, accum_dtype)
    batch = {"tokens": ab.sds((B, S), torch.int32)}
    batch_sh = {"tokens": _shard_like(mesh, (B, S), "batch", "seq")}
    return BuiltStep(
        name=f"{entry.arch_id}/{shape.name}", fn=train_step,
        args=(state_abs, batch), in_shardings=(state_sh, batch_sh),
        model_flops=_lm_model_flops(cfg, B * S),  # 6·N·D (fwd+bwd)
        opt_name=opt_name, fake_mode=ab.mode)


def build_lm_prefill(entry: ArchEntry, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg: T.TransformerConfig = entry.config
    B, S = shape.params["global_batch"], shape.params["seq_len"]
    ab = _Abstract(_device_of(mesh))
    ctx = ShardCtx(mesh)
    specs = T.build_specs(cfg)
    params_abs = ab.params(specs)
    param_sh = spec_shardings(specs, mesh)

    def prefill(params, tokens):
        logits, _ = T.forward(params, tokens, cfg, ctx)
        return logits[:, -1]

    tokens = ab.sds((B, S), torch.int32)
    tok_sh = _shard_like(mesh, (B, S), "batch", "seq")
    return BuiltStep(
        name=f"{entry.arch_id}/{shape.name}", fn=_replicating(prefill),
        args=(params_abs, tokens), in_shardings=(param_sh, tok_sh),
        model_flops=_lm_model_flops(cfg, B * S) / 3.0 * 1.0,
        fake_mode=ab.mode)


def build_lm_decode(entry: ArchEntry, shape: ShapeSpec, mesh,
                    long_context: bool = False) -> BuiltStep:
    cfg: T.TransformerConfig = entry.config
    B, S_ctx = shape.params["global_batch"], shape.params["seq_len"]
    ab = _Abstract(_device_of(mesh))
    ctx = ShardCtx(mesh)
    specs = T.build_specs(cfg)
    params_abs = ab.params(specs)
    param_sh = spec_shardings(specs, mesh)
    cspecs = T.cache_specs(cfg, B, S_ctx, long_context=long_context)
    cache_abs = ab.params(cspecs)
    cache_sh = spec_shardings(cspecs, mesh)

    def step(params, cache, tokens, cache_len):
        return T.decode_step(params, cache, tokens, cache_len, cfg, ctx)

    args = (params_abs, cache_abs, ab.sds((B,), torch.int32),
            ab.sds((B,), torch.int32))
    in_sh = (param_sh, cache_sh,
             _shard_like(mesh, (B,), "batch"),
             _shard_like(mesh, (B,), "batch"))
    return BuiltStep(
        name=f"{entry.arch_id}/{shape.name}", fn=_replicating(step),
        args=args, in_shardings=in_sh,
        model_flops=_lm_model_flops(cfg, B, decode=True, ctx_len=S_ctx)
        / 3.0, fake_mode=ab.mode)


# ---------------------------------------------------------------------------
# GNN steps
# ---------------------------------------------------------------------------

def _gnn_batch_abs(ab: _Abstract, entry, cfg, shape: ShapeSpec, mesh):
    p = shape.params
    n_pad, e_pad = p["n_pad"], p["e_pad"]
    n_graphs = p.get("batch", 1)
    batch = {
        "senders": ab.sds((e_pad,), torch.int32),
        "receivers": ab.sds((e_pad,), torch.int32),
        "node_mask": ab.sds((n_pad,), torch.bool),
    }
    sh = {
        "senders": _shard_like(mesh, (e_pad,), "edges"),
        "receivers": _shard_like(mesh, (e_pad,), "edges"),
        "node_mask": _shard_like(mesh, (n_pad,), "nodes"),
    }
    if entry.arch_id == "gat-cora":
        d_feat = p.get("d_feat", 602 if shape.kind == "gnn_minibatch"
                       else 16)
        batch["node_feat"] = ab.sds((n_pad, d_feat), torch.float32)
        batch["labels"] = ab.sds((n_pad,), torch.int32)
        sh["node_feat"] = _shard_like(mesh, (n_pad, d_feat), "nodes", "feat")
        sh["labels"] = _shard_like(mesh, (n_pad,), "nodes")
    else:
        batch["species"] = ab.sds((n_pad,), torch.int32)
        batch["positions"] = ab.sds((n_pad, 3), torch.float32)
        batch["graph_id"] = ab.sds((n_pad,), torch.int32)
        batch["labels"] = ab.sds((n_graphs,), torch.float32)
        sh["species"] = _shard_like(mesh, (n_pad,), "nodes")
        sh["positions"] = _shard_like(mesh, (n_pad, 3), "nodes", None)
        sh["graph_id"] = _shard_like(mesh, (n_pad,), "nodes")
        sh["labels"] = _repl(mesh)
    if entry.arch_id == "dimenet":
        t_pad = 2 * e_pad
        batch["trip_kj"] = ab.sds((t_pad,), torch.int32)
        batch["trip_ji"] = ab.sds((t_pad,), torch.int32)
        sh["trip_kj"] = _shard_like(mesh, (t_pad,), "edges")
        sh["trip_ji"] = _shard_like(mesh, (t_pad,), "edges")
    return batch, sh, n_pad, n_graphs


def _gnn_loss(entry, cfg, n_pad, n_graphs, ctx):
    mod = GNN_MODULES[entry.arch_id]

    def loss(params, batch):
        gb = GraphBatch(
            senders=batch["senders"], receivers=batch["receivers"],
            n_node=n_pad, node_feat=batch.get("node_feat"),
            species=batch.get("species"), positions=batch.get("positions"),
            graph_id=batch.get("graph_id"), n_graphs=n_graphs,
            labels=batch["labels"], node_mask=batch["node_mask"],
            trip_kj=batch.get("trip_kj"), trip_ji=batch.get("trip_ji"))
        return mod.loss_fn(params, gb, cfg, ctx)
    return loss


def _gnn_model_flops(entry, cfg, shape: ShapeSpec) -> float:
    p = shape.params
    e = p["e_pad"]
    n = p["n_pad"]
    if entry.arch_id == "gat-cora":
        d = p.get("d_feat", 16)
        per_edge = 4 * cfg.n_heads * cfg.d_hidden
        per_node = 2 * d * cfg.n_heads * cfg.d_hidden
        return 3.0 * cfg.n_layers * (e * per_edge + n * per_node)
    if entry.arch_id == "schnet":
        per_edge = 2 * cfg.n_rbf * cfg.d_hidden + 2 * cfg.d_hidden ** 2 \
            + 2 * cfg.d_hidden
        per_node = 6 * cfg.d_hidden ** 2
        return 3.0 * cfg.n_interactions * (e * per_edge + n * per_node)
    if entry.arch_id == "nequip":
        C = cfg.d_hidden
        per_edge = 50 * C * 9        # ~paths x cartesian contraction cost
        per_node = 6 * C * C * 9
        return 3.0 * cfg.n_layers * (e * per_edge + n * per_node)
    if entry.arch_id == "dimenet":
        t = 2 * e
        d = cfg.d_hidden
        per_t = 2 * d * cfg.n_bilinear
        per_e = 8 * d * d
        return 3.0 * cfg.n_blocks * (t * per_t + e * per_e)
    return 0.0


def build_gnn_train(entry: ArchEntry, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg = entry.config
    if entry.arch_id == "gat-cora":
        d_feat = shape.params.get("d_feat",
                                  602 if shape.kind == "gnn_minibatch"
                                  else 16)
        cfg = dataclasses.replace(cfg, d_in=d_feat)
    ab = _Abstract(_device_of(mesh))
    mod = GNN_MODULES[entry.arch_id]
    specs = mod.build_specs(cfg)
    batch, batch_sh, n_pad, n_graphs = _gnn_batch_abs(ab, entry, cfg, shape,
                                                      mesh)
    loss = _gnn_loss(entry, cfg, n_pad, n_graphs, ShardCtx(mesh))
    train_step, state_abs, state_sh = _state_pack(ab, mesh, specs, loss,
                                                  "adamw")
    return BuiltStep(
        name=f"{entry.arch_id}/{shape.name}", fn=train_step,
        args=(state_abs, batch), in_shardings=(state_sh, batch_sh),
        model_flops=_gnn_model_flops(entry, cfg, shape), opt_name="adamw",
        fake_mode=ab.mode)


# ---------------------------------------------------------------------------
# RecSys steps
# ---------------------------------------------------------------------------

def _dlrm_batch_abs(ab: _Abstract, cfg: DL.DLRMConfig, B: int, mesh):
    batch = {"dense": ab.sds((B, cfg.n_dense), torch.float32),
             "sparse": ab.sds((B, cfg.n_sparse, cfg.bag_size), torch.int32),
             "labels": ab.sds((B,), torch.float32)}
    sh = {"dense": _shard_like(mesh, (B, cfg.n_dense), "batch", None),
          "sparse": _shard_like(mesh, (B, cfg.n_sparse, cfg.bag_size),
                                "batch", None, None),
          "labels": _shard_like(mesh, (B,), "batch")}
    return batch, sh


def _dlrm_model_flops(cfg: DL.DLRMConfig, B: int, train: bool) -> float:
    mlp = 0
    dims = [cfg.n_dense] + list(cfg.bot_mlp)
    mlp += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    dims = [cfg.n_interact + cfg.bot_mlp[-1]] + list(cfg.top_mlp)
    mlp += sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    inter = 2 * (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
    lookup = 2 * cfg.n_sparse * cfg.bag_size * cfg.embed_dim
    per_ex = mlp + inter + lookup
    return (3.0 if train else 1.0) * B * per_ex


def build_dlrm_train(entry: ArchEntry, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg: DL.DLRMConfig = entry.config
    B = shape.params["batch"]
    ab = _Abstract(_device_of(mesh))
    ctx = ShardCtx(mesh)
    specs = DL.build_specs(cfg)
    loss = lambda p, b: DL.loss_fn(p, b, cfg, ctx)  # noqa: E731
    train_step, state_abs, state_sh = _state_pack(ab, mesh, specs, loss,
                                                  "adamw")
    batch, batch_sh = _dlrm_batch_abs(ab, cfg, B, mesh)
    return BuiltStep(
        name=f"{entry.arch_id}/{shape.name}", fn=train_step,
        args=(state_abs, batch), in_shardings=(state_sh, batch_sh),
        model_flops=_dlrm_model_flops(cfg, B, True), opt_name="adamw",
        fake_mode=ab.mode)


def build_dlrm_serve(entry: ArchEntry, shape: ShapeSpec, mesh) -> BuiltStep:
    cfg: DL.DLRMConfig = entry.config
    B = shape.params["batch"]
    ab = _Abstract(_device_of(mesh))
    ctx = ShardCtx(mesh)
    specs = DL.build_specs(cfg)
    params_abs = ab.params(specs)
    param_sh = spec_shardings(specs, mesh)
    batch, batch_sh = _dlrm_batch_abs(ab, cfg, B, mesh)
    del batch["labels"], batch_sh["labels"]

    def serve(params, batch):
        return torch.sigmoid(DL.forward(params, batch, cfg, ctx))

    return BuiltStep(
        name=f"{entry.arch_id}/{shape.name}", fn=_replicating(serve),
        args=(params_abs, batch), in_shardings=(param_sh, batch_sh),
        model_flops=_dlrm_model_flops(cfg, B, False), fake_mode=ab.mode)


def build_dlrm_retrieval(entry: ArchEntry, shape: ShapeSpec,
                         mesh) -> BuiltStep:
    cfg: DL.DLRMConfig = entry.config
    B, Nc = shape.params["batch"], shape.params["n_candidates"]
    ab = _Abstract(_device_of(mesh))
    ctx = ShardCtx(mesh)
    specs = DL.build_specs(cfg)
    params_abs = ab.params(specs)
    param_sh = spec_shardings(specs, mesh)
    batch = {"dense": ab.sds((B, cfg.n_dense), torch.float32),
             "sparse": ab.sds((B, cfg.n_sparse, cfg.bag_size), torch.int32),
             "candidates": ab.sds((Nc, cfg.embed_dim), torch.float32)}
    sh = {"dense": _repl(mesh), "sparse": _repl(mesh),
          "candidates": _shard_like(mesh, (Nc, cfg.embed_dim),
                                    "nodes", None)}

    def retrieve(params, batch):
        return DL.retrieval_score(params, batch, cfg, ctx, top_k=100)

    return BuiltStep(
        name=f"{entry.arch_id}/{shape.name}", fn=_replicating(retrieve),
        args=(params_abs, batch), in_shardings=(param_sh, sh),
        model_flops=2.0 * Nc * cfg.embed_dim, fake_mode=ab.mode)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

def build_step(entry: ArchEntry, shape_name: str, mesh) -> BuiltStep:
    shape = entry.shape(shape_name)
    if shape.kind == "train":
        return build_lm_train(entry, shape, mesh)
    if shape.kind == "prefill":
        return build_lm_prefill(entry, shape, mesh)
    if shape.kind == "decode":
        return build_lm_decode(entry, shape, mesh)
    if shape.kind == "long_decode":
        return build_lm_decode(entry, shape, mesh, long_context=True)
    if shape.kind in ("gnn_full", "gnn_minibatch", "gnn_molecule"):
        return build_gnn_train(entry, shape, mesh)
    if shape.kind == "recsys_train":
        return build_dlrm_train(entry, shape, mesh)
    if shape.kind == "recsys_serve":
        return build_dlrm_serve(entry, shape, mesh)
    if shape.kind == "recsys_retrieval":
        return build_dlrm_retrieval(entry, shape, mesh)
    raise ValueError(shape.kind)
