"""Named-axis sharding rules: logical parameter/activation axes -> mesh
axes — port of ``repro.dist.sharding``.

Every model declares *logical* axes on its ``ParamSpec``s and activation
constraints ('batch', 'embed', 'mlp', ...). This module owns the single
mapping from those names to physical mesh axes ('data', 'model', 'pe'),
with the reference's invariant: **the planner never produces an invalid
sharding** — a dim that is not divisible by its mesh axis, or a mesh
axis used twice in one spec, falls back to replication for that dim.

A spec is a tuple with one entry per dim (``None``, a mesh axis name or
a tuple of names): the reference's ``PartitionSpec``. A mesh is any
object with ``axis_names`` and per-axis sizes, read from
``axis_sizes`` or else from ``devices.shape`` (the reference's ``Mesh``
layout): ``api.runtime.PeMesh`` is a 1-D ``("pe",)`` mesh, and
``MeshShape`` names one that has no processes (a session's mesh before
it is spawned).

``ShardCtx.constrain`` is the identity wherever the resolved spec
replicates every dim, which is what the reference's sharding constraint
computes there. That covers every rule on a ``pe`` mesh, since
``DEFAULT_RULES`` maps nothing to ``pe``. A spec that would really split
an array (``data`` / ``model`` meshes) raises: the port has no
multi-card model layout yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

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

SPLIT_MESHES_ITEM = ("ROADMAP queue 1, item (d): one-node "
                     "launch/{mesh,steps}.py and the data/model meshes")


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind them."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]


def _mesh_sizes(mesh) -> Dict[str, int]:
    sizes = getattr(mesh, "axis_sizes", None)
    if sizes is None:
        sizes = mesh.devices.shape
    return dict(zip(mesh.axis_names, (int(s) for s in sizes)))


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


class ShardCtx:
    """Sharding context threaded through model forward passes.

    ``constrain(x, *logical_axes)`` is the identity with no mesh
    (``NULL_CTX``) and wherever the resolved spec replicates every dim;
    a spec that splits ``x`` raises ``NotImplementedError``.
    """

    def __init__(self, mesh=None, rules: Mapping[str, Any] = DEFAULT_RULES):
        self.mesh = mesh
        self.rules = rules

    def constrain(self, x, *axes: Optional[str]):
        if self.mesh is None:
            return x
        spec = resolve_axes(x.shape, axes, self.mesh, self.rules)
        if any(s is not None for s in spec):
            raise NotImplementedError(
                f"ShardCtx.constrain: {tuple(x.shape)} over {axes} would "
                f"be split as {spec} on the mesh {_mesh_sizes(self.mesh)}; "
                f"the port has no split layouts yet ({SPLIT_MESHES_ITEM})")
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
        names = None if self.mesh is None else tuple(self.mesh.axis_names)
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
