"""Model substrate: parameter specs with logical sharding axes, init,
and the small set of NN ops everything reuses — port of
``repro.models.common``.

Every parameter is declared as a ``ParamSpec`` carrying its *logical*
axes ('embed', 'mlp', 'heads', 'vocab', 'expert', ...), which
``dist/sharding.py`` maps onto mesh axes. A spec tree is a nested dict
of ``ParamSpec``; a parameter tree the same dicts of tensors, keyed as
the reference keys them, so a reference tree crosses over key for key
(``repro_torch.carry.model_from``).

``init_params`` draws from an explicit ``torch.Generator``. JAX's
threefry stream has no torch counterpart, so equal seeds give other
weights in the two packages: parity runs on carried weights.

``abstract_params`` is the dry-run's counterpart of the reference's
``ShapeDtypeStruct`` trees: fake tensors, which have a shape, a dtype
and a device but no storage. ``distribute`` lays a tree of real or fake
leaves out as DTensors over a ``DeviceMesh`` by a tree of spec tuples.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from ..kernels.dispatch import resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]          # logical axis per dim
    init: str = "normal"                     # normal | zeros | ones | embed
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"ParamSpec: shape {self.shape} and axes "
                             f"{self.axes} differ in length")


SpecTree = Any     # nested dict of ParamSpec
ParamTree = Any    # nested dict of torch.Tensor


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], specs: SpecTree):
    """``fn`` over every ``ParamSpec`` of a nested dict, same structure."""
    if is_spec(specs):
        return fn(specs)
    return {k: tree_map_specs(fn, v) for k, v in specs.items()}


def spec_leaves(specs: SpecTree):
    """``(path, spec)`` pairs in the reference's leaf order (dict keys
    sorted at every level, as ``jax.tree_util`` flattens them)."""
    if is_spec(specs):
        return [((), specs)]
    out = []
    for k in sorted(specs):
        out += [((k,) + p, s) for p, s in spec_leaves(specs[k])]
    return out


def _std(spec: ParamSpec) -> float:
    if spec.init == "embed":
        return spec.scale
    fan_in = spec.shape[0] if len(spec.shape) >= 2 else \
        max(1, math.prod(spec.shape))
    return spec.scale / math.sqrt(fan_in)


# a leaf of another dtype than float32 is drawn this many float32
# normals at a time (arctic's bf16 e_in is 8.93e9 elements a layer)
DRAW_CHUNK = 1 << 26


def init_params(specs: SpecTree, generator: torch.Generator,
                device=None) -> ParamTree:
    """Parameters of ``specs`` on ``device`` (the card by default):
    zeros, ones, or normals of the reference's scale, drawn one leaf
    after the other in the reference's leaf order on ``generator``'s
    device (a CUDA generator draws on the card).

    A float32 leaf is one draw of its shape. A leaf of another dtype is
    drawn in float32 ``DRAW_CHUNK`` elements at a time along its
    flattened order, each slice scaled and rounded into the leaf, so it
    never needs a float32 copy of itself whole."""
    device = resolve_device(device)

    def one(spec: ParamSpec) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=spec.dtype, device=device)
        if spec.dtype != torch.float32:
            out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
            flat = out.view(-1)
            for i in range(0, flat.numel(), DRAW_CHUNK):
                n = min(DRAW_CHUNK, flat.numel() - i)
                x = torch.randn((n,), generator=generator,
                                dtype=torch.float32, device=generator.device)
                flat[i:i + n] = x.mul_(_std(spec))
            return out
        x = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=generator.device)
        return (x.mul_(_std(spec))).to(device=device, dtype=spec.dtype)

    return _tree_of(specs, {path: one(s) for path, s in spec_leaves(specs)})


def _tree_of(specs: SpecTree, leaves: Dict, path=()) -> Any:
    """``specs``' nested dicts with ``leaves[path]`` at each spec. (A
    module function: a nested recursive one would sit in a reference
    cycle with ``leaves``, which would then outlive the tree until the
    cycle collector ran: gigabytes on the card.)"""
    if is_spec(specs):
        return leaves[path]
    return {k: _tree_of(v, leaves, path + (k,)) for k, v in specs.items()}


def abstract_params(specs: SpecTree, fake_mode=None, device="cpu"):
    """Fake tensors of each spec's shape and dtype on ``device`` (no
    storage is allocated), made in ``fake_mode`` (a new
    ``FakeTensorMode`` by default): the reference's dry-run inputs."""
    if fake_mode is None:
        from torch._subclasses.fake_tensor import FakeTensorMode
        fake_mode = FakeTensorMode()
    with fake_mode:
        return tree_map_specs(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device=device),
            specs)


def map_with_specs(fn: Callable, tree, specs):
    """``fn(leaf, spec)`` over the tensors of ``tree``, where ``specs``
    is a tree of the same dicts and sequences with a spec tuple at each
    tensor (so a spec tuple is never walked into); other leaves stay."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_specs(fn, v, s)
                          for v, s in zip(tree, specs))
    return tree


def distribute(tree, spec_tree, mesh):
    """DTensors over ``mesh`` of a tree of real or fake tensors, each laid
    out by its spec tuple (``dist.sharding.placements``). Every rank
    holds the same whole leaves and keeps its own piece: nothing is sent
    (``src_data_rank=None``)."""
    from ..dist.sharding import placements

    def one(leaf, spec):
        return distribute_tensor(leaf, mesh, placements(spec, mesh),
                                 src_data_rank=None)
    return map_with_specs(one, tree, spec_tree)


def replicated_like(x, t):
    """``t`` as a replicated DTensor on ``x``'s mesh where ``x`` is a
    DTensor and ``t`` a plain tensor; else ``t`` as it is."""
    if isinstance(x, DTensor) and not isinstance(t, DTensor):
        mesh = x.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return t


def has_values(t) -> bool:
    """``t`` holds values the host can read: not a fake tensor (a
    dry-run's), nor a DTensor of fake local pieces."""
    from torch._subclasses.fake_tensor import is_fake
    if isinstance(t, DTensor):
        t = t.to_local()
    return not is_fake(t)


def param_count(specs: SpecTree) -> int:
    return sum(math.prod(s.shape) for _, s in spec_leaves(specs))


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def rms_norm(x, gamma, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    return (out * gamma + beta).to(x.dtype)


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


_ACT: Dict[str, Callable] = {
    # jax.nn.gelu's default is the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "ssp": lambda x: softplus(x) - math.log(2.0),   # shifted softplus
    "tanh": torch.tanh,
}


def act_fn(name: str):
    return _ACT[name]


def rope(x, positions, theta: float = 10000.0):
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * replicated_like(positions, freqs)
    ang = ang[..., None, :]                           # (..., S, 1, half)
    # positions made by the model are plain tensors: on a mesh they are
    # the same on every rank
    cos = replicated_like(x, torch.cos(ang))
    sin = replicated_like(x, torch.sin(ang))
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _split_ce_terms(logits: DTensor, labels):
    """``(lse, ll)`` of DTensor logits, each rank working on its own
    piece: where the class dim is split, the max, the sum of exponents
    and the picked logit are reduced across its shards (the max is a
    stabiliser and carries no gradient), so no rank holds every class."""
    from torch.distributed.tensor import Partial

    from ..dist.sharding import contiguous_stride, shard_offset, \
        to_placements
    mesh, nd = logits.device_mesh, logits.dim()
    logits = to_placements(logits, mesh, tuple(
        Replicate() if p.is_partial() else p for p in logits.placements))
    cls = [m for m, p in enumerate(logits.placements) if p.is_shard(nd - 1)]
    lead = tuple(Replicate() if m in cls else p
                 for m, p in enumerate(logits.placements))
    lab = to_placements(labels, mesh, lead).to_local().long()
    x = logits.to_local().float()
    off, width = shard_offset(logits, nd - 1), x.shape[-1]
    shape = tuple(logits.shape[:-1])
    stride = contiguous_stride(shape)

    def put(t, red):
        return DTensor.from_local(t, mesh, tuple(
            Partial(red) if m in cls else p for m, p in enumerate(lead)),
            run_check=False, shape=shape, stride=stride)
    m = put(x.amax(dim=-1).detach(), "max").redistribute(
        mesh, lead).to_local()
    total = put(torch.exp(x - m[..., None]).sum(dim=-1), "sum")
    inside = (lab >= off) & (lab < off + width)
    pick = torch.gather(x, -1, torch.clamp(lab - off, 0, width - 1)[..., None])
    ll = put(torch.where(inside, pick[..., 0], 0.0), "sum")
    m = DTensor.from_local(m, mesh, lead, run_check=False, shape=shape,
                           stride=stride)
    return m + torch.log(total), ll


def cross_entropy_loss(logits, labels, mask=None, z_loss: float = 0.0):
    """Stable CE in fp32; optional z-loss (log-sum-exp regularizer)."""
    if isinstance(logits, DTensor):
        lse, ll = _split_ce_terms(logits, labels)
    else:
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    if mask is not None:
        return torch.sum(loss * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(loss)
