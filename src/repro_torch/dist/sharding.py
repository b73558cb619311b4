"""Named-axis sharding rules: logical parameter/activation axes -> mesh
axes — port of ``repro.dist.sharding``.

Every model declares *logical* axes on its ``ParamSpec``s and activation
constraints ('batch', 'embed', 'mlp', ...). This module owns the single
mapping from those names to physical mesh axes ('data', 'model', 'pe'),
with the reference's invariant: **the planner never produces an invalid
sharding** — a dim that is not divisible by its mesh axis, or a mesh
axis used twice in one spec, falls back to replication for that dim.

A spec is a tuple with one entry per dim (``None``, a mesh axis name or
a tuple of names): the reference's ``PartitionSpec``. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` (its ``mesh_dim_names``
and ``shape``) or any object with ``axis_names`` and per-axis sizes,
read from ``axis_sizes`` or else from ``devices.shape`` (the
reference's ``Mesh`` layout): ``api.runtime.PeMesh`` is a 1-D
``("pe",)`` mesh, and ``MeshShape`` names one that has no processes (a
session's mesh before it is spawned).

The split layouts are DTensors over a ``DeviceMesh``: ``placements``
turns a spec into one ``Shard(dim)`` / ``Replicate()`` per mesh
dimension, and ``ShardCtx.constrain`` redistributes to them, the part
the reference's sharding constraint plays for GSPMD. A mesh of axis
sizes alone has no ranks to split over: there ``constrain`` is the
identity wherever the resolved spec replicates every dim (every rule on
a ``pe`` mesh, since ``DEFAULT_RULES`` maps nothing to ``pe``), and a
spec that would split an array raises. ``reshape`` is a reshape that
first replicates each sharded dim the new shape cannot keep sharded,
which GSPMD does implicitly; ``rowwise`` and ``local_param`` run a
function on each rank's own rows where DTensor has no rule for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

# logical axis -> mesh axis (or tuple of mesh axes). Axes absent from the
# map (or mapped to None) replicate. 'embed' stays replicated on purpose:
# it co-occurs with 'mlp'/'heads'/'vocab' in every matmul param, and those
# carry the model-parallel split.
DEFAULT_RULES: Dict[str, Any] = {
    # data-parallel activation axes
    "batch": "data",
    "nodes": "data",
    "edges": "data",
    # model-parallel (tensor) axes
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "table": "model",
    # sequence / feature / stacked-layer axes replicate by default
    "seq": None,
    "act_seq": None,
    "feat": None,
    "embed": None,
    "head_dim": None,
    "table_dim": None,
    "stack": None,
}

Spec = Tuple[Any, ...]

@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind them."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]


def axis_names(mesh) -> Tuple[str, ...]:
    if isinstance(mesh, DeviceMesh):
        return tuple(mesh.mesh_dim_names)
    return tuple(mesh.axis_names)


def _mesh_sizes(mesh) -> Dict[str, int]:
    if isinstance(mesh, DeviceMesh):
        sizes = mesh.shape
    else:
        sizes = getattr(mesh, "axis_sizes", None)
        if sizes is None:
            sizes = mesh.devices.shape
    return dict(zip(axis_names(mesh), (int(s) for s in sizes)))


def resolve_axes(shape: Sequence[int],
                 axes: Sequence[Optional[str]],
                 mesh,
                 rules: Mapping[str, Any] = DEFAULT_RULES) -> Spec:
    """Map logical ``axes`` of an array of ``shape`` to a spec tuple.

    Falls back to replication per-dim whenever the rule's mesh axis is
    absent from the mesh, already consumed by an earlier dim, trivial
    (size 1), or does not divide the dim.
    """
    sizes = _mesh_sizes(mesh)
    used: set = set()
    spec = []
    for dim, logical in zip(shape, axes):
        target = rules.get(logical) if logical is not None else None
        if target is None:
            spec.append(None)
            continue
        names: Tuple[str, ...] = (target,) if isinstance(target, str) \
            else tuple(target)
        prod = 1
        ok = True
        for nm in names:
            if nm not in sizes or nm in used or sizes[nm] <= 1:
                ok = False
                break
            prod *= sizes[nm]
        if not ok or prod <= 1 or dim % prod != 0:
            spec.append(None)
            continue
        used.update(names)
        spec.append(names[0] if len(names) == 1 else names)
    return tuple(spec)


def spec_shardings(specs, mesh, rules: Mapping[str, Any] = DEFAULT_RULES):
    """ParamSpec tree -> spec-tuple tree (same structure)."""
    from ..models.common import tree_map_specs
    return tree_map_specs(
        lambda s: resolve_axes(s.shape, s.axes, mesh, rules), specs)


def placements(spec: Spec, mesh: DeviceMesh) -> Tuple[Any, ...]:
    """One placement per mesh dimension: ``Shard(d)`` where dim ``d`` of
    ``spec`` names that mesh axis (alone or in a tuple), else
    ``Replicate()``. Several mesh axes on one dim shard it in the mesh's
    axis order, major first."""
    out: List[Any] = [Replicate()] * mesh.ndim
    names = axis_names(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for nm in ((entry,) if isinstance(entry, str) else entry):
            out[names.index(nm)] = Shard(d)
    return tuple(out)


def is_split(x) -> bool:
    """``x`` is a DTensor sharded or partial on some mesh dimension."""
    return isinstance(x, DTensor) and any(
        not p.is_replicate() for p in x.placements)


def to_placements(x, mesh: DeviceMesh, target) -> DTensor:
    """``x`` as a DTensor of ``target`` placements (a plain tensor is
    taken as replicated on every rank)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(target):
        return x
    return x.redistribute(mesh, tuple(target))


def local_param(p, mesh: DeviceMesh, target, partial_dims=()):
    """``p`` laid out as ``target`` and taken local, for a computation on
    each rank's own rows: its gradient is a partial sum over
    ``partial_dims``, the mesh dims whose ranks used it on different
    rows."""
    t = to_placements(p, mesh, target)
    return t.to_local(grad_placements=tuple(
        Partial() if m in partial_dims else pl
        for m, pl in enumerate(target)))


def contiguous_stride(shape) -> Tuple[int, ...]:
    out, n = [], 1
    for s in reversed(tuple(shape)):
        out.append(n)
        n *= s
    return tuple(reversed(out))


def rowwise(fn, *xs):
    """``fn`` over each rank's own rows of the DTensors ``xs`` (dim 0,
    split as the first one splits it; every other dim gathered), its
    tensor outputs (a tensor, or a dict of them) put back as DTensors
    split so. For row-local functions that DTensor has no rule for."""
    lead = next(x for x in xs if isinstance(x, DTensor))
    mesh = lead.device_mesh
    rows = tuple(p if p.is_shard(0) else Replicate()
                 for p in lead.placements)
    n = lead.shape[0]
    out = fn(*(to_placements(x, mesh, rows).to_local() for x in xs))

    def back(t):
        shape = (n,) + tuple(t.shape[1:])
        return DTensor.from_local(t, mesh, rows, run_check=False,
                                  shape=shape, stride=contiguous_stride(shape))
    if isinstance(out, dict):
        return {k: back(v) for k, v in out.items()}
    return back(out)


def shard_offset(x: DTensor, dim: int) -> int:
    """Index in dim ``dim`` of the first element of this rank's piece of
    ``x``, split evenly over the mesh dims that shard it (major first)."""
    mesh, idx = x.device_mesh, 0
    coord = mesh.get_coordinate()
    for m, p in enumerate(x.placements):
        if p.is_shard(dim):
            idx = idx * mesh.size(m) + coord[m]
    return idx * x.to_local().shape[dim]


def _groups(src: Sequence[int], dst: Sequence[int]):
    """Pairs ``(in_dims, out_dims)`` of a reshape from ``src`` to
    ``dst``: the shortest runs of dims whose sizes multiply to the same
    number."""
    out, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj, a, b = [], [], 1, 1
        if i < len(src):
            a, i = a * src[i], i + 1
            gi.append(i - 1)
        if j < len(dst):
            b, j = b * dst[j], j + 1
            gj.append(j - 1)
        while a != b:
            if a < b:
                a, i = a * src[i], i + 1
                gi.append(i - 1)
            else:
                b, j = b * dst[j], j + 1
                gj.append(j - 1)
        out.append((gi, gj))
    return out


def _reshape(x, shape: Sequence[int]):
    shape = list(shape)
    if -1 in shape:
        i = shape.index(-1)
        rest = math.prod(s for k, s in enumerate(shape) if k != i)
        shape[i] = x.numel() // max(rest, 1)
    src = list(x.shape)
    first = {}        # input dim -> output dim it keeps its shards on
    for gi, gj in _groups(src, shape):
        d_in = next((d for d in gi if src[d] != 1), None)
        d_out = next((d for d in gj if shape[d] != 1), None)
        if d_in is not None and d_out is not None:
            first[d_in] = d_out
    mesh = x.device_mesh
    new = list(x.placements)
    count: Dict[int, int] = {}
    for m, p in enumerate(x.placements):
        if not p.is_shard():
            continue
        count[p.dim] = count.get(p.dim, 1) * mesh.size(m)
        out_d = first.get(p.dim)
        if out_d is None or src[p.dim] % count[p.dim] or \
                shape[out_d] % count[p.dim]:
            new[m] = Replicate()
    if new != list(x.placements):
        x = x.redistribute(mesh, tuple(new))
    return x.reshape(shape)


class _Reshape(torch.autograd.Function):
    """``_reshape`` forward, and ``_reshape`` of the gradient back to the
    input's shape: torch's own reshape backward would view the gradient
    into a strided layout no product has a rule for."""

    @staticmethod
    def forward(ctx, x, shape):
        ctx.shape = tuple(x.shape)
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, grad):
        if not is_split(grad):
            return grad.reshape(ctx.shape), None
        return _reshape(grad, ctx.shape), None


def reshape(x, shape: Sequence[int]):
    """``x.reshape(shape)``. On a DTensor, each ``Shard(d)`` the new
    shape cannot keep first becomes ``Replicate()``: a dim merged with
    others keeps its shards only as the group's first non-1 dim, a dim
    split keeps them only on its first part, and only if that part
    divides evenly; its gradient is reshaped back by the same rule.
    GSPMD gathers there implicitly; torch's view rules refuse instead."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, tuple(shape))


class ShardCtx:
    """Sharding context threaded through model forward passes.

    ``constrain(x, *logical_axes)`` is the identity with no mesh
    (``NULL_CTX``). On a ``DeviceMesh`` it redistributes ``x`` (a
    DTensor, or a plain tensor taken as replicated) to the resolved
    spec's placements. On a mesh of axis sizes alone it is the identity
    wherever the resolved spec replicates every dim, and a spec that
    splits ``x`` raises ``NotImplementedError``.
    """

    def __init__(self, mesh=None, rules: Mapping[str, Any] = DEFAULT_RULES):
        self.mesh = mesh
        self.rules = rules

    def constrain(self, x, *axes: Optional[str]):
        if self.mesh is None:
            return x
        spec = resolve_axes(x.shape, axes, self.mesh, self.rules)
        if isinstance(self.mesh, DeviceMesh):
            target = placements(spec, self.mesh)
            if not isinstance(x, DTensor) and all(
                    p.is_replicate() for p in target):
                return x
            return to_placements(x, self.mesh, target)
        if any(s is not None for s in spec):
            raise NotImplementedError(
                f"ShardCtx.constrain: {tuple(x.shape)} over {axes} would "
                f"be split as {spec} on the mesh {_mesh_sizes(self.mesh)}, "
                "which has no ranks: a split needs a DeviceMesh")
        return x

    def data_groups(self) -> int:
        """Number of shards along the data-parallel axis (>= 1) — the
        group count for group-local MoE dispatch."""
        if self.mesh is None:
            return 1
        target = self.rules.get("batch")
        if target is None:
            return 1
        names = (target,) if isinstance(target, str) else tuple(target)
        sizes = _mesh_sizes(self.mesh)
        g = 1
        for nm in names:
            g *= sizes.get(nm, 1)
        return max(1, g)

    def __repr__(self) -> str:
        names = None if self.mesh is None else axis_names(self.mesh)
        return f"ShardCtx(mesh={names})"


NULL_CTX = ShardCtx(None)


def pe_ctx(devices: int, mesh=None) -> ShardCtx:
    """A session's context: ``NULL_CTX`` for one device, else a
    ``ShardCtx`` over ``mesh`` or, before one is spawned, over a
    ``MeshShape`` of ``devices`` PEs on the ``pe`` axis."""
    if devices <= 1:
        return NULL_CTX
    return ShardCtx(mesh if mesh is not None
                    else MeshShape(("pe",), (devices,)))
