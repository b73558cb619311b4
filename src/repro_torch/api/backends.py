"""String-keyed backend registry for the partitioning facade — port of
``repro.api.backends``.

A backend is a callable ``(g, req, ctx) -> assignment`` where ``ctx`` is
a ``BackendContext`` carrying the torch device, an optional trace list
``partition`` appends per-level records to, and optional precomputed
level-0 labels. Built-ins:

  * ``single``          — single-process deep MGP (``core.deep_mgp``)
  * ``dist``            — distributed deep MGP, direct all-to-all
  * ``dist-grid``       — distributed deep MGP, two-level grid routing
  * ``plain_mgp``       — classic multilevel baseline
  * ``single_level_lp`` — XtraPuLP-like single-level LP baseline

The ``dist`` backends run SPMD, one rank a PE, under an initialised
``torch.distributed`` group of ``req.devices`` ranks (every rank calls
``Partitioner.run`` with the same request and gets the same result):
``api.runtime.distributed_init`` makes it, or ``launch/partition.py
--devices P``. A one-device request with no group makes a one-rank group
itself (NCCL on the card, gloo on the CPU). Given a mesh
(``BackendContext.mesh``, an ``api.runtime.PeMesh`` a serving session
owns), they send the request to the mesh's ranks instead and return its
rank 0's answer, as the reference passes ``mesh=ctx.mesh``. They honor the request's
distributed memory-model knobs (``contraction``, ``weights``,
``balance``) through ``req.resolve_config()``.

The baselines being ordinary backends is what makes ``--compare`` "run
the same request against N backends".
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core import baselines
from ..core.deep_mgp import partition as _single_partition
from ..graphs.format import Graph

BackendFn = Callable[..., np.ndarray]

_REGISTRY: Dict[str, BackendFn] = {}
# names safe to serve inside a coalesced/stacked batch: deterministic
# pure single-device backends. Custom backends are excluded unless
# registered with batchable=True.
_BATCHABLE: set = set()

# below this many vertices per PE, sharding overhead dominates and the
# auto policy stays single-process (the reference's constants)
MIN_VERTICES_PER_DEVICE = 64
# grid all-to-all routing pays off once the PE count is large (paper §5)
GRID_ROUTING_MIN_DEVICES = 16
DISTRIBUTED = ("dist", "dist-grid")


def register_backend(name: str, fn: Optional[BackendFn] = None, *,
                     batchable: bool = False):
    """Register ``fn`` under ``name``; usable as a decorator.

    ``batchable=True`` declares the backend safe for batched dispatch
    (pure, deterministic, single-device); the default keeps custom
    backends on the solo path."""
    def _do(f: BackendFn) -> BackendFn:
        if not name or not isinstance(name, str):
            raise ValueError("backend name must be a non-empty str, "
                             f"got {name!r}")
        _REGISTRY[name] = f
        if batchable:
            _BATCHABLE.add(name)
        else:
            _BATCHABLE.discard(name)
        return f
    return _do(fn) if fn is not None else _do


def is_batchable(name: str) -> bool:
    """True when ``name`` was registered as safe for batched dispatch."""
    return name in _BATCHABLE


def get_backend(name: str) -> BackendFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; available: "
                         f"{available_backends()}") from None


def available_backends() -> List[str]:
    return sorted(_REGISTRY)


@dataclasses.dataclass
class BackendContext:
    """Per-run state the facade threads into a backend."""
    device: torch.device
    devices: int = 1
    trace: Optional[list] = None
    # precomputed level-0 clustering labels; must be exactly what
    # core.coarsening.cluster would return for partition's level-0 call
    level0_labels: Optional[np.ndarray] = None
    # a PeMesh of ``devices`` rank processes the dist backends run on
    mesh: Optional[object] = None
    # the request's GraphSpec, if it had one: a mesh sends it in place
    # of the materialized graph's arrays
    spec: Optional[object] = None


def resolve_backend(req, n_graph_vertices: int) -> str:
    """The ``auto`` policy: distributed iff the caller asked for more
    than one device AND the graph is big enough to shard; grid routing
    once the PE count is large. Pure function of the request."""
    if req.backend != "auto":
        return req.backend
    P = req.devices
    if P > 1 and n_graph_vertices >= MIN_VERTICES_PER_DEVICE * P:
        return "dist-grid" if P >= GRID_ROUTING_MIN_DEVICES else "dist"
    return "single"


def required_devices(req, n_graph_vertices: int) -> int:
    """PE count the request's *resolved* backend needs: its ``devices``
    field for the distributed backends, 1 for everything else. Pure
    (same inputs as ``resolve_backend``)."""
    name = resolve_backend(req, n_graph_vertices)
    return max(1, req.devices) if name in DISTRIBUTED else 1


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

@register_backend("single", batchable=True)
def _single(g: Graph, req, ctx: BackendContext) -> np.ndarray:
    return _single_partition(g, req.k, req.resolve_config(),
                             trace=ctx.trace,
                             level0_labels=ctx.level0_labels,
                             device=ctx.device)


def _dist(g: Graph, req, ctx: BackendContext,
          use_grid: bool) -> np.ndarray:
    from ..dist.dist_partitioner import dist_partition_impl
    from .runtime import pe_group
    P = max(1, ctx.devices)
    if ctx.mesh is not None:
        if ctx.mesh.size != P:
            raise ValueError(f"a request for {P} devices on a mesh of "
                             f"{ctx.mesh.size}")
        reply = ctx.mesh.partition(
            dataclasses.replace(req, graph=ctx.spec or g),
            "dist-grid" if use_grid else "dist")
        if ctx.trace is not None:
            ctx.trace.extend(reply.local)
        return reply.value[0]
    return dist_partition_impl(g, req.k, P, cfg=req.resolve_config(),
                               use_grid=use_grid,
                               pe=pe_group(P, ctx.device), trace=ctx.trace)


@register_backend("dist")
def _dist_direct(g: Graph, req, ctx: BackendContext) -> np.ndarray:
    return _dist(g, req, ctx, use_grid=False)


@register_backend("dist-grid")
def _dist_grid(g: Graph, req, ctx: BackendContext) -> np.ndarray:
    return _dist(g, req, ctx, use_grid=True)


@register_backend("plain_mgp", batchable=True)
def _plain_mgp(g: Graph, req, ctx: BackendContext) -> np.ndarray:
    return baselines.plain_mgp(g, req.k, cfg=req.resolve_config(),
                               device=ctx.device)


@register_backend("single_level_lp", batchable=True)
def _single_level_lp(g: Graph, req, ctx: BackendContext) -> np.ndarray:
    return baselines.single_level_lp(g, req.k, eps=req.epsilon,
                                     seed=req.seed, device=ctx.device)
