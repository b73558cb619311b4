"""Decoder-only transformer LM: dense + MoE, GQA/MQA, RoPE, GLU FFNs —
port of ``repro.models.transformer`` (prefill, loss with its gradient
through autograd, KV-cache decode).

One definition serves all five LM architectures. Parameters are the
reference's spec tree: the layers stacked under ``params["layers"]``
with a leading layer axis, so a reference tree crosses over key for key
(``repro_torch.carry.model_from``). ``forward`` takes each stacked leaf
apart once (``torch.unbind``), so in backward each leaf's gradient is
assembled once from its layers' slices. ``scan_layers`` is kept as a
field; both settings run the same loop. ``remat`` is the reference's
``jax.checkpoint`` of a layer: with it, and with autograd recording,
each layer runs under ``torch.utils.checkpoint`` and is recomputed in
backward; it changes no number.

Numerics follow the reference's dtypes op by op:

* a Python float that meets a tensor is first rounded to the tensor's
  dtype (``weak``), as JAX's weak typing rounds it: ``x * sqrt(2048)``
  on bf16 multiplies by bf16(45.2548...) = 45.25, where torch would
  multiply by the float and round once;
* the reference's ``preferred_element_type=float32`` products (bf16
  operands, float32 result) cast their operands to float32, which is
  exact, and multiply in float32; bf16 values are exact in TF32 too,
  but with ``compute_dtype=float32`` TF32 must be off to match;
* the FFN activations are the reference's op sequences, each op
  rounded to the tensor's dtype as XLA rounds it (``act``): silu is
  x * 1/(1 + exp(-x)) and the tanh GELU its eight ops, so bf16
  activations equal the reference's bit for bit (torch's fused
  ``F.silu`` rounds once and differs in ~4 of 10 bf16 values);
* attention is the reference's blockwise running softmax in torch ops
  (``_blockwise_self_attention``): the (S, S) scores are never
  materialised, only (B, S, Hkv, rep, blk) float32 a block, and under
  autograd each block is recomputed in backward (the reference's
  ``jax.checkpoint(body)``) rather than kept;
* MoE routing is bit-identical given equal gates: ``lax.top_k`` order
  (descending, ties to the lower index) by a stable sort, the
  reference's stable argsort, left ``searchsorted``, capacity cut and
  sentinel slot (``routing_plan``).

On a ``DeviceMesh`` context the parameters and activations are DTensors
(``dist/sharding.py``), and each step GSPMD takes implicitly is taken
here by name, so the values are the reference's at the same mesh: a
reshape that merges or splits a sharded dim first replicates what it
cannot keep (``sharding.reshape``); the GLU's stacked ``w_in`` is
multiplied a half at a time, which keeps its ``mlp`` shards; each rank
takes the embedding rows its vocab shard holds, summed across the
shards (one nonzero row each); attention runs on each rank's own batch
rows and kv heads; the MoE's routing, gather and combine run on each
rank's own token groups (one group a ``data`` rank, as the reference
blocks them) with only the expert matmuls on DTensors; decode writes
each rank's own rows of the cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from ..dist.sharding import NULL_CTX, ShardCtx, contiguous_stride, \
    is_split, local_param, shard_offset, to_placements
from ..dist.sharding import reshape as _rs
from .common import ParamSpec, act_fn, cross_entropy_loss, rms_norm, rope

# an expert weight cast to the compute dtype is made this many bytes at
# a time (arctic's e_in is 35.7 GB a layer in float32)
CAST_CHUNK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    glu: bool = True                  # gated FFN (SwiGLU/GeGLU)
    activation: str = "silu"          # silu -> SwiGLU, gelu_tanh -> GeGLU
    qkv_bias: bool = False            # qwen2
    tied_embeddings: bool = False     # gemma
    rope_theta: float = 10000.0
    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_dense_residual: bool = False  # arctic: dense FFN + MoE in parallel
    moe_d_ff: int = 0                 # per-expert hidden (defaults to d_ff)
    # numerics / memory
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat: bool = True                # recompute each layer in backward
    scan_layers: bool = True          # both settings run the same loop
    logit_softcap: float = 0.0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def expert_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def vocab_pad(self) -> int:
        """Vocab rounded to a multiple of 256; padded logit columns are
        masked with -1e30 in forward/decode."""
        return -(-self.vocab // 256) * 256


def build_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    L, d, pd = cfg.n_layers, cfg.d_model, cfg.param_dtype
    ffn_mult = 2 if cfg.glu else 1

    def P(shape, axes, **kw):
        return ParamSpec(tuple(shape), tuple(axes), dtype=pd, **kw)

    layer: Dict[str, Any] = {
        "ln_attn": P((L, d), ("stack", "embed"), init="zeros"),
        "ln_ffn": P((L, d), ("stack", "embed"), init="zeros"),
        "wq": P((L, d, cfg.n_heads, cfg.head_dim),
                ("stack", "embed", "heads", "head_dim")),
        "wk": P((L, d, cfg.n_kv_heads, cfg.head_dim),
                ("stack", "embed", "kv_heads", "head_dim")),
        "wv": P((L, d, cfg.n_kv_heads, cfg.head_dim),
                ("stack", "embed", "kv_heads", "head_dim")),
        "wo": P((L, cfg.n_heads, cfg.head_dim, d),
                ("stack", "heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        layer["bq"] = P((L, cfg.n_heads, cfg.head_dim),
                        ("stack", "heads", "head_dim"), init="zeros")
        layer["bk"] = P((L, cfg.n_kv_heads, cfg.head_dim),
                        ("stack", "kv_heads", "head_dim"), init="zeros")
        layer["bv"] = P((L, cfg.n_kv_heads, cfg.head_dim),
                        ("stack", "kv_heads", "head_dim"), init="zeros")
    if cfg.moe_dense_residual or not cfg.moe:
        layer["w_in"] = P((L, d, ffn_mult, cfg.d_ff),
                          ("stack", "embed", None, "mlp"))
        layer["w_out"] = P((L, cfg.d_ff, d), ("stack", "mlp", "embed"))
    if cfg.moe:
        E, f = cfg.n_experts, cfg.expert_ff
        layer["router"] = P((L, d, E), ("stack", "embed", "expert"))
        layer["e_in"] = P((L, E, d, ffn_mult, f),
                          ("stack", "expert", "embed", None, "mlp"))
        layer["e_out"] = P((L, E, f, d), ("stack", "expert", "mlp", "embed"))
    specs: Dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_pad, d), ("vocab", "embed"),
                           init="embed", scale=0.02, dtype=pd),
        "ln_f": P((d,), ("embed",), init="zeros"),
        "layers": layer,
    }
    if not cfg.tied_embeddings:
        specs["head"] = P((d, cfg.vocab_pad), ("embed", "vocab"))
    return specs


def weak(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d CPU tensor of ``x``'s dtype: a Python float
    rounded as JAX's weak typing rounds it before it meets ``x`` (an op
    takes a 0-d CPU tensor as a scalar on any device)."""
    return torch.tensor(value, dtype=x.dtype)


def _silu(x):
    return x * torch.reciprocal(1 + torch.exp(-x))


def _gelu_tanh(x):
    inner = weak(x, math.sqrt(2 / math.pi)) * (
        x + weak(x, 0.044715) * x ** 3)
    return x * (weak(x, 0.5) * (1 + torch.tanh(inner)))


_ACT = {"silu": _silu, "gelu_tanh": _gelu_tanh, "gelu": _gelu_tanh}


def act(name: str):
    """The reference's activation ``name`` op by op: ``jax.nn.silu`` is
    logistic (1/(1 + exp(-x)) in XLA) times x, ``jax.nn.gelu`` (tanh
    form) 0.5 (1 + tanh(sqrt(2/pi) (x + 0.044715 x^3))) x, each op
    rounded to ``x``'s dtype; other names are ``common.act_fn``'s."""
    return _ACT.get(name) or act_fn(name)


def _layer(params, li: int) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s parameters (views into the stacked leaves)."""
    return {k: v[li] for k, v in params["layers"].items()}


def _layers(params, n_layers: int):
    """Every layer's parameters, each stacked leaf taken apart by one
    ``torch.unbind``: in backward its gradient is then one stack of the
    layers' gradients, where a ``v[li]`` a layer would give each layer a
    full-size gradient of the leaf."""
    parts = {k: torch.unbind(v) for k, v in params["layers"].items()}
    return [{k: v[li] for k, v in parts.items()} for li in range(n_layers)]


def _recorded(fn, *args):
    """``fn(*args)``, recomputed in backward when autograd records it: a
    tensor among ``args`` (or in a dict of them) requires grad."""
    flat = [v for a in args
            for v in (a.values() if isinstance(a, dict) else (a,))]
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in flat):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _embed(params, tokens, cfg: TransformerConfig) -> torch.Tensor:
    """``embed.astype(cd)[tokens] * sqrt(d_model)``; the rows are taken
    before the cast, which gives the same values."""
    if isinstance(params["embed"], DTensor):
        x = _embed_split(params["embed"], tokens).to(cfg.compute_dtype)
    else:
        x = params["embed"][tokens].to(cfg.compute_dtype)
    return x * weak(x, math.sqrt(cfg.d_model))


def _embed_split(embed: DTensor, tokens) -> DTensor:
    """``embed[tokens]`` of a DTensor table: each rank takes the rows of
    its own vocab shard (zeros for the others' tokens) for its own batch
    rows, and the shards' partial rows are summed at once, which is one
    nonzero row each: the same values."""
    mesh, nd = embed.device_mesh, embed.device_mesh.ndim
    vocab = [m for m, p in enumerate(embed.placements) if p.is_shard(0)]
    tp = tokens.placements if isinstance(tokens, DTensor) else \
        (Replicate(),) * nd
    rows = tuple(Shard(0) if p.is_shard(0) and m not in vocab
                 else Replicate() for m, p in enumerate(tp))
    lay = tuple(Shard(0) if m in vocab else Replicate() for m in range(nd))
    batch = [m for m, p in enumerate(rows) if p.is_shard(0)]
    table = to_placements(embed, mesh, lay)
    off = shard_offset(table, 0)
    local = local_param(embed, mesh, lay, batch)
    tok = to_placements(tokens, mesh, rows).to_local().long() - off
    inside = (tok >= 0) & (tok < local.shape[0])
    x = local[torch.clamp(tok, 0, local.shape[0] - 1)]
    x = torch.where(inside[..., None], x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
    shape = tuple(tokens.shape) + (embed.shape[1],)
    x = DTensor.from_local(x, mesh, tuple(
        Partial() if m in vocab else rows[m] for m in range(nd)),
        run_check=False, shape=shape, stride=contiguous_stride(shape))
    return to_placements(x, mesh, rows)


def _head(params, cfg: TransformerConfig) -> torch.Tensor:
    head = params["embed"].T if cfg.tied_embeddings else params["head"]
    return head.to(cfg.compute_dtype)


# ---------------------------------------------------------------------------
# MoE layer (sort-based dispatch, static capacity)
# ---------------------------------------------------------------------------

def routing_plan(eid: torch.Tensor, cap: int, n_experts: int, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's per-group dispatch plan, for all G groups at once.

    ``eid``: (G, Tg*k) expert ids of each token's k choices, token-major.
    Returns ``src_tok`` (G, E*cap), the token of each expert slot (Tg,
    the zero row, where a slot is empty), and ``slot_of`` (G, Tg*k), the
    slot of each choice (E*cap, the zero row, where the expert was full):
    a choice's rank among its expert's choices, in token order, must be
    below ``cap``."""
    G, N = eid.shape
    Tg, E = N // k, n_experts
    dev = eid.device
    s_eid, order = torch.sort(eid, dim=1, stable=True)
    start = torch.searchsorted(s_eid, s_eid, right=False)
    rank = torch.arange(N, device=dev) - start
    slot = torch.where(rank < cap, s_eid * cap + rank, E * cap)
    tokid = torch.arange(N, device=dev) // k
    # slot -> source token; the sentinel column E*cap takes every dropped
    # choice and is cut off
    src_tok = torch.full((G, E * cap + 1), Tg, dtype=torch.int64,
                         device=dev).scatter_(1, slot, tokid[order])
    slot_of = torch.empty_like(slot).scatter_(1, order, slot)
    return src_tok[:, :E * cap], slot_of


def _expert_matmul(a: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    """``a @ w.astype(cd)`` batched over the leading expert axis. A
    weight already in ``cd`` is used as it is; otherwise it is cast
    ``CAST_CHUNK_BYTES`` at a time, a few experts after the other."""
    if w.dtype == cd:
        return torch.matmul(a, w)
    per = max(1, CAST_CHUNK_BYTES // (w[0].numel() * cd.itemsize))
    return torch.cat([torch.matmul(a[i:i + per], w[i:i + per].to(cd))
                      for i in range(0, w.shape[0], per)])


def _route(x, router, cfg: TransformerConfig):
    """Top-k routing of the (T, d) tokens ``x``: the normalised top-k
    weights and expert ids (T, k), and the aux loss's mean gate and
    routed fraction per expert."""
    E, k = cfg.n_experts, cfg.top_k
    logits = x.float() @ router.float()
    gates = torch.softmax(logits, dim=-1)                     # (T, E)
    # lax.top_k: descending, ties to the lower index
    topw, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    me = gates.mean(dim=0)
    ce = torch.nn.functional.one_hot(topi[:, 0], E).float().mean(dim=0)
    return topw, topi, me, ce


def _dispatch(xg, topi, cap: int, cfg: TransformerConfig):
    """Each group's tokens gathered into its experts' slots: ``buf``
    (G, E, cap, d), and the routing plan (``routing_plan``)."""
    G, Tg, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    src_tok, slot_of = routing_plan(topi.reshape(G, Tg * k), cap, E, k)
    grp = torch.arange(G, device=xg.device)[:, None]
    xp = torch.cat([xg, xg.new_zeros((G, 1, d))], dim=1)
    return xp[grp, src_tok].reshape(G, E, cap, d), slot_of


def _combine(out_buf, slot_of, wsg, k: int):
    """(G, E, cap, d) expert outputs -> each group's (G, Tg, d) tokens,
    their k choices weighted and summed."""
    G, E, cap, d = out_buf.shape
    grp = torch.arange(G, device=out_buf.device)[:, None]
    flat = torch.cat([out_buf.reshape(G, E * cap, d),
                      out_buf.new_zeros((G, 1, d))], dim=1)
    rows = flat[grp, slot_of]                                 # (G, Tg*k, d)
    rows = rows * wsg.to(rows.dtype)[..., None]
    return rows.reshape(G, -1, k, d).sum(dim=2)


def _experts(lp, buf, cfg: TransformerConfig, ctx: ShardCtx):
    """(E, G, cap, d) slots through their experts' FFNs -> (E, G, cap, d),
    laid out as the reference constrains it."""
    E, G, cap, d = buf.shape
    f, cd = cfg.expert_ff, cfg.compute_dtype
    buf = ctx.constrain(buf, "expert", "batch", None, "embed")
    g = 2 if cfg.glu else 1
    split = is_split(lp["e_in"])

    def mm(a, w):
        return torch.matmul(a, w.to(cd)) if split else \
            _expert_matmul(a, w, cd)
    h = mm(_rs(buf, (E, G * cap, d)), _rs(lp["e_in"], (E, d, g * f)))
    h = _rs(h, (E, G, cap, g, f))
    if cfg.glu:
        h = act(cfg.activation)(h[..., 0, :]) * h[..., 1, :]
    else:
        h = act(cfg.activation)(h[..., 0, :])
    out_buf = mm(_rs(h, (E, G * cap, f)), lp["e_out"])
    return ctx.constrain(_rs(out_buf, (E, G, cap, d)),
                         "expert", "batch", None, "embed")


def _groups(T: int, ctx: ShardCtx) -> int:
    G = ctx.data_groups()
    while T % G:
        G //= 2
    return G


def moe_ffn(lp, x, cfg: TransformerConfig, ctx: ShardCtx):
    """x: (T, d) -> (T, d), plus the Switch load-balancing aux loss.

    Group-local dispatch as the reference's: tokens are blocked into G
    groups (``ctx.data_groups()``, 1 on a replicating context), each
    group routes its tokens into E experts of ``cap`` slots, and every
    heavy move is a row gather."""
    if isinstance(x, DTensor):
        return _moe_ffn_split(lp, x, cfg, ctx)
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = _groups(T, ctx)
    Tg = T // G
    cap = max(1, int(math.ceil(Tg * k * cfg.capacity_factor / E)))
    topw, topi, me, ce = _route(x, lp["router"], cfg)
    aux = E * torch.sum(me * ce)

    xg = ctx.constrain(x.reshape(G, Tg, d), "batch", None, "embed")
    buf, slot_of = _dispatch(xg, topi, cap, cfg)
    out_buf = _experts(lp, buf.transpose(0, 1), cfg, ctx)
    out_buf = out_buf.transpose(0, 1)                         # (G, E, cap, d)
    out_buf = ctx.constrain(out_buf, "batch", "expert", None, "embed")
    y = _combine(out_buf, slot_of, topw.reshape(G, Tg * k), k)
    y = ctx.constrain(y, "batch", None, "embed")
    return y.reshape(T, d), aux


def _moe_ffn_split(lp, x, cfg: TransformerConfig, ctx: ShardCtx):
    """``moe_ffn`` on DTensors. Where the G groups are the ``data``
    ranks' rows, each rank routes, gathers and combines its own group
    (the reference's vmap over groups, split as its data axis splits
    them); otherwise every rank does all G groups. Only the expert
    matmuls run on DTensors: the (G, E, ...) <-> (E, G, ...) reshards
    around them are the expert-parallel exchange."""
    mesh = x.device_mesh
    T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    G = _groups(T, ctx)
    Tg = T // G
    cap = max(1, int(math.ceil(Tg * k * cfg.capacity_factor / E)))
    target = ctx.rules.get("batch")
    data = (target,) if isinstance(target, str) else tuple(target or ())
    dims = [i for i, nm in enumerate(mesh.mesh_dim_names) if nm in data]
    D = math.prod(mesh.size(i) for i in dims)
    own = D > 1 and G == D         # one group a data rank
    rows = tuple(Shard(0) if own and i in dims else Replicate()
                 for i in range(mesh.ndim))
    gl = 1 if own else G           # groups on this rank
    # a rank's own groups: the router's gradient from them is a part of
    # the sum over the data ranks
    part = tuple(Partial() if own and i in dims else Replicate()
                 for i in range(mesh.ndim))
    xl = to_placements(x, mesh, rows).to_local()
    router = to_placements(lp["router"], mesh, (Replicate(),) * mesh.ndim
                           ).to_local(grad_placements=part)
    topw, topi, me, ce = _route(xl, router, cfg)
    # the means of D equal groups sum to the global means
    me, ce = (DTensor.from_local(t / (D if own else 1), mesh, part,
                                 run_check=False) for t in (me, ce))
    aux = E * torch.sum(me * ce)

    buf, slot_of = _dispatch(xl.reshape(gl, Tg, d), topi, cap, cfg)
    egrp = tuple(Shard(1) if own and i in dims else Replicate()
                 for i in range(mesh.ndim))
    buf = DTensor.from_local(buf.transpose(0, 1), mesh, egrp,
                             run_check=False, shape=(E, G, cap, d),
                             stride=contiguous_stride((E, G, cap, d)))
    out_buf = _experts(lp, buf, cfg, ctx).transpose(0, 1)     # (G, E, cap, d)
    out_buf = ctx.constrain(out_buf, "batch", "expert", None, "embed")
    ob = to_placements(out_buf, mesh, rows).to_local()
    y = _combine(ob, slot_of, topw.reshape(gl, Tg * k), k)
    y = DTensor.from_local(y, mesh, rows, run_check=False,
                           shape=(G, Tg, d),
                           stride=contiguous_stride((G, Tg, d)))
    y = ctx.constrain(y, "batch", None, "embed")
    return _rs(y, (T, d)), aux


def dense_ffn(lp, x, cfg: TransformerConfig):
    cd = cfg.compute_dtype
    d, g, f = lp["w_in"].shape
    if is_split(lp["w_in"]):
        # (d, g, f) -> (d, g f) would merge the mlp shards into a
        # strided layout: one product a half keeps them
        w = lp["w_in"].to(cd)
        hs = [x @ w[:, i] for i in range(g)]
        h = act(cfg.activation)(hs[0])
        return (h * hs[1] if cfg.glu else h) @ lp["w_out"].to(cd)
    h = (x @ lp["w_in"].to(cd).reshape(d, g * f)).reshape(-1, g, f)
    if cfg.glu:
        h = act(cfg.activation)(h[:, 0]) * h[:, 1]
    else:
        h = act(cfg.activation)(h[:, 0])
    return h @ lp["w_out"].to(cd)


def _ffn(lp, hin, cfg: TransformerConfig, ctx: ShardCtx):
    """The MoE and/or dense FFN of one layer, summed in the reference's
    order; returns (out, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=hin.device)
    out = torch.zeros_like(hin)
    if cfg.moe:
        mo, aux = moe_ffn(lp, hin, cfg, ctx)
        out = out + mo
    if cfg.moe_dense_residual or not cfg.moe:
        out = out + dense_ffn(lp, hin, cfg)
    return out, aux


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _project(x, w, cd):
    """``einsum("bsd,dhq->bshq", x, w.astype(cd))``."""
    d, h, q = w.shape
    return _rs(x @ _rs(w.to(cd), (d, h * q)), (*x.shape[:-1], h, q))


def attention(lp, x, positions, cfg: TransformerConfig, ctx: ShardCtx,
              kv_cache: Optional[Tuple] = None,
              cache_len: Optional[torch.Tensor] = None):
    """x: (B, S, d). With ``kv_cache=(k, v)`` of (B, S_ctx, Hkv, hd)
    performs decode: the queries attend to the cache's first
    ``cache_len`` slots and, causally, to themselves. Returns (y, (k,
    v)) with the fresh (B, S, Hkv, hd) keys and values."""
    B, S, d = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.compute_dtype
    q = _project(x, lp["wq"], cd)
    k = _project(x, lp["wk"], cd)
    v = _project(x, lp["wv"], cd)
    if cfg.qkv_bias:
        q = q + lp["bq"].to(cd)
        k = k + lp["bk"].to(cd)
        v = v + lp["bv"].to(cd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = ctx.constrain(q, "batch", "seq", "heads", "head_dim")
    k = ctx.constrain(k, "batch", "seq", "kv_heads", "head_dim")

    new_kv = (k, v)
    rep = H // Hkv
    if kv_cache is None:
        out = _blockwise_self_attention(q, k, v, positions, cfg, ctx)
    else:
        ck, cv = kv_cache                                 # (B, Sc, Hkv, hd)
        qg = _rs(q, (B, S, Hkv, rep, hd))
        if isinstance(qg, DTensor):
            out = _on_own_heads(_attend_cache, qg, (ck, cv, k, v),
                                (cache_len,))
        else:
            out = _attend_cache(qg, ck, cv, k, v, cache_len)
        out = _rs(out, (B, S, H, hd))
    y = _rs(out, (B, S, H * hd)) @ _rs(lp["wo"].to(cd), (H * hd, d))
    return y, new_kv


def _blockwise_self_attention(q, k, v, positions, cfg: TransformerConfig,
                              ctx: ShardCtx, kv_block: int = 1024):
    """Causal self-attention with a running softmax over KV blocks of
    ``kv_block`` (halved until it divides S): per block only (B, S, Hkv,
    rep, blk) float32 scores, never (S, S). Scores, the running max, the
    sum and the accumulator are float32; the probabilities meet V in
    the compute dtype's rounding, as the reference's ``p.astype(cd)``."""
    B, S, Hkv, hd = k.shape
    H = q.shape[2]
    rep = H // Hkv
    qg = _rs(q, (B, S, Hkv, rep, hd))
    qg = ctx.constrain(qg, "batch", "act_seq", "kv_heads", None, None)
    if isinstance(qg, DTensor):
        out = _on_own_heads(_running_softmax, qg, (k, v), (positions,),
                            kv_block=kv_block)
    else:
        out = _running_softmax(qg, k, v, positions, kv_block=kv_block)
    out = _rs(out, (B, S, H, hd))
    return ctx.constrain(out, "batch", "act_seq", None, None)


def _running_softmax(qg, k, v, positions, kv_block: int):
    """The running softmax of ``_blockwise_self_attention`` on grouped
    queries (B, S, Hkv, rep, hd): (B, S, Hkv, rep, hd) in q's dtype."""
    B, S, Hkv, rep, hd = qg.shape
    cd = qg.dtype
    blk = min(kv_block, S)
    while S % blk:
        blk //= 2
    q32 = qg.float()
    scale = 1.0 / math.sqrt(hd)
    dev = qg.device
    m = torch.full((B, S, Hkv, rep), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((B, S, Hkv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, Hkv, rep, hd), dtype=torch.float32, device=dev)
    for j in range(0, S, blk):
        m, l, acc = _recorded(_attend_block, q32, k[:, j:j + blk],
                              v[:, j:j + blk], positions,
                              positions[:, j:j + blk], m, l, acc, scale, cd)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(cd)


def _attend_cache(qg, ck, cv, k, v, cache_len):
    """Decode attention of grouped queries (B, S, Hkv, rep, hd) over the
    cache's (B, Sc, Hkv, hd) keys and values, the first ``cache_len``
    valid, and causally over the S fresh ones."""
    B, S, Hkv, rep, hd = qg.shape
    cd = qg.dtype
    k = torch.cat([ck.to(cd), k], dim=1)
    v = torch.cat([cv.to(cd), v], dim=1)
    S_kv = k.shape[1]
    # preferred_element_type=float32: bf16 operands, float32 result
    scores = torch.einsum("bshrd,bthd->bhrst", qg.float(), k.float())
    scores = scores / math.sqrt(hd)
    # cache slots 0..cache_len-1 are valid history; the S fresh slots
    # (appended at the end) are causal among themselves
    S_c = S_kv - S
    dev = qg.device
    valid_cache = (torch.arange(S_c, device=dev)[None, None, :]
                   < cache_len[:, None, None]).expand(B, S, S_c)
    ar = torch.arange(S, device=dev)
    valid_new = (ar[None, None, :] <= ar[None, :, None]).expand(B, S, S)
    mask = torch.cat([valid_cache, valid_new], dim=2)
    scores = torch.where(mask[:, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(cd)
    return torch.einsum("bhrst,bthd->bshrd", probs, v)


def _on_own_heads(fn, qg, kv, per_row, **kw):
    """``fn(qg, *kv, *per_row)`` on each rank's own batch rows and kv
    heads: attention is independent across both, so no rank needs
    another's. ``qg`` (B, S, Hkv, rep, hd) and each of ``kv`` (B, ., Hkv,
    .) keep their dim-0 and dim-2 shards, ``per_row`` tensors (B, ...)
    their dim-0 ones; every other dim is gathered."""
    mesh = qg.device_mesh
    lay = tuple(p if p.is_shard(0) or p.is_shard(2) else Replicate()
                for p in qg.placements)
    rows = tuple(p if p.is_shard(0) else Replicate() for p in lay)
    out = fn(to_placements(qg, mesh, lay).to_local(),
             *(to_placements(t, mesh, lay).to_local() for t in kv),
             *(to_placements(t, mesh, rows).to_local() for t in per_row),
             **kw)
    return DTensor.from_local(out, mesh, lay, run_check=False,
                              shape=qg.shape,
                              stride=contiguous_stride(qg.shape))


def _attend_block(q32, kk, vv, q_pos, k_pos, m, l, acc, scale: float, cd):
    """One KV block of the running softmax: the new (max, sum,
    accumulator). Out of place throughout, since autograd keeps the
    scores and probabilities it needs for backward."""
    s = torch.einsum("bshrd,bkhd->bshrk", q32, kk.float()) * scale
    mask = q_pos[:, :, None] >= k_pos[:, None, :]
    s = torch.where(mask[:, :, None, None, :], s, -1e30)
    m2 = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m2[..., None])
    corr = torch.exp(m - m2)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bshrk,bkhd->bshrd", p.to(cd).float(), vv.float())
    return m2, l, acc


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------

def _vocab_pad_bias(cfg: TransformerConfig, dtype, device):
    """0 on the vocab's columns, -1e30 (float32, then ``dtype``) on the
    padded ones."""
    if cfg.vocab_pad == cfg.vocab:
        return torch.zeros((cfg.vocab_pad,), dtype=dtype, device=device)
    col = torch.arange(cfg.vocab_pad, device=device)
    return torch.where(col < cfg.vocab, 0.0, -1e30).to(dtype)


def _layer_fn(lp, x, positions, cfg, ctx):
    B, S, d = x.shape
    h, _ = attention(lp, rms_norm(x, lp["ln_attn"]), positions, cfg, ctx)
    x = x + h
    x = ctx.constrain(x, "batch", "act_seq", "embed")
    hin = _rs(rms_norm(x, lp["ln_ffn"]), (B * S, d))
    out, aux = _ffn(lp, hin, cfg, ctx)
    x = x + _rs(out, (B, S, d))
    x = ctx.constrain(x, "batch", "act_seq", "embed")
    return x, aux


def _logits(params, x, cfg: TransformerConfig, softcap: bool):
    """Final norm, head and the padded columns' bias; ``forward`` also
    soft-caps (the reference's ``decode_step`` does not)."""
    x = rms_norm(x, params["ln_f"])
    logits = x @ _head(params, cfg)
    if softcap and cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / weak(logits, c)) * weak(logits, c)
    return logits + _vocab_pad_bias(cfg, logits.dtype, logits.device)


def forward(params, tokens, cfg: TransformerConfig,
            ctx: ShardCtx = NULL_CTX, positions=None):
    """tokens: (B, S) -> (logits (B, S, vocab_pad), aux_loss)."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    x = ctx.constrain(x, "batch", "act_seq", "embed")
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _layers(params, cfg.n_layers):
        if cfg.remat:
            x, a = _recorded(_layer_fn, lp, x, positions, cfg, ctx)
        else:
            x, a = _layer_fn(lp, x, positions, cfg, ctx)
        aux = aux + a
    logits = _logits(params, x, cfg, softcap=True)
    logits = ctx.constrain(logits, "batch", "seq", "vocab")
    return logits, aux


def loss_fn(params, batch, cfg: TransformerConfig, ctx: ShardCtx = NULL_CTX):
    """Next-token cross entropy plus 0.01 x the MoE aux loss; both carry
    their gradients (the aux loss's reaches the router through the
    gates)."""
    logits, aux = forward(params, batch["tokens"], cfg, ctx)
    loss = cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:],
                              mask=batch.get("mask", None))
    return loss + 0.01 * aux


# ---------------------------------------------------------------------------
# serving (KV-cache decode)
# ---------------------------------------------------------------------------

def cache_specs(cfg: TransformerConfig, batch: int, max_len: int,
                long_context: bool = False):
    """KV cache as ParamSpecs (zeros, the compute dtype). For
    long-context serving the sequence axis is ``kv_seq``."""
    seq_ax = "kv_seq" if long_context else "seq"
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    axes = ("stack", "batch", seq_ax, "kv_heads", "head_dim")
    return {
        "k": ParamSpec(shape, axes, init="zeros", dtype=cfg.compute_dtype),
        "v": ParamSpec(shape, axes, init="zeros", dtype=cfg.compute_dtype),
    }


def _write_split(c, new, cache_len):
    """``decode_step``'s cache write on a DTensor layer cache ``c`` (B,
    S, Hkv, hd): each rank writes its own rows and heads of the fresh
    (B, 1, Hkv, hd) ``new`` into its piece. A cache split along its
    sequence takes the reference's one-hot add instead."""
    mesh = c.device_mesh
    if any(p.is_shard(1) or p.is_partial() for p in c.placements):
        oh = torch.arange(c.shape[1], device=c.device)[None, :] == \
            cache_len[:, None]                                # (B, S)
        c.add_(oh[:, :, None, None].to(c.dtype) * new.to(c.dtype))
        return
    # new and cache_len laid out as c's (B, ., Hkv, hd) dims are
    nl = to_placements(new, mesh, c.placements).to_local()[:, 0]
    lens = to_placements(cache_len, mesh, tuple(
        p if p.is_shard(0) else Replicate()
        for p in c.placements)).to_local()
    cl = c.to_local()
    S_max = cl.shape[1]
    rows = torch.arange(cl.shape[0], device=cl.device)
    live = (lens < S_max)[:, None, None]
    slot = torch.clamp(lens, max=S_max - 1)
    cl[rows, slot] = torch.where(live, nl.to(cl.dtype), cl[rows, slot])


def decode_step(params, cache, tokens, cache_len, cfg: TransformerConfig,
                ctx: ShardCtx = NULL_CTX):
    """One decode step. tokens: (B,) ints; cache_len: (B,) current
    lengths. Returns (logits (B, vocab_pad), cache).

    The returned cache is the argument, updated in place: each layer
    writes the new token's K/V at slot ``cache_len`` (a row's write is
    dropped where ``cache_len`` is past the cache, as the reference's
    one-hot drops it). The reference adds a one-hot product over the
    whole cache instead, which equals this write where the slot holds
    zeros, as every slot at and past ``cache_len`` does in a cache filled
    by decode steps from zeros."""
    B = tokens.shape[0]
    x = _embed(params, tokens, cfg)[:, None, :]
    positions = cache_len[:, None]
    S_max = cache["k"].shape[2]
    rows = torch.arange(B, device=x.device)
    live = (cache_len < S_max)[:, None, None]
    slot = torch.clamp(cache_len, max=S_max - 1)
    for li, lp in enumerate(_layers(params, cfg.n_layers)):
        ck, cv = cache["k"][li], cache["v"][li]
        h, (nk, nv) = attention(lp, rms_norm(x, lp["ln_attn"]), positions,
                                cfg, ctx, kv_cache=(ck, cv),
                                cache_len=cache_len)
        x = x + h
        hin = _rs(rms_norm(x, lp["ln_ffn"]), (B, -1))
        out, _ = _ffn(lp, hin, cfg, ctx)
        x = x + _rs(out, (B, 1, -1))
        if isinstance(ck, DTensor):
            _write_split(ck, nk, cache_len)
            _write_split(cv, nv, cache_len)
            continue
        ck[rows, slot] = torch.where(live, nk[:, 0].to(ck.dtype),
                                     ck[rows, slot])
        cv[rows, slot] = torch.where(live, nv[:, 0].to(cv.dtype),
                                     cv[rows, slot])
    logits = _logits(params, x, cfg, softcap=False)[:, 0]
    return logits, cache
