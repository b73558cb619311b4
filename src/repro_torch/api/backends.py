"""String-keyed backend registry for the partitioning facade — port of
``repro.api.backends``.

A backend is a callable ``(g, req, ctx) -> assignment`` where ``ctx`` is
a ``BackendContext`` carrying the torch device, an optional trace list
``partition`` appends per-level records to, and optional precomputed
level-0 labels. This slice of the port registers ``single`` (the
single-process deep MGP of ``core.deep_mgp``); the distributed backends
and the baselines are later slices. The ``auto`` policy is the
reference's, so a request that it sends to ``dist`` or ``dist-grid``
raises until those backends are ported (ROADMAP.md, queue 1 item 5).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.deep_mgp import partition as _single_partition
from ..graphs.format import Graph

BackendFn = Callable[..., np.ndarray]

_REGISTRY: Dict[str, BackendFn] = {}

# below this many vertices per PE, sharding overhead dominates and the
# auto policy stays single-process (the reference's constants)
MIN_VERTICES_PER_DEVICE = 64
# grid all-to-all routing pays off once the PE count is large (paper §5)
GRID_ROUTING_MIN_DEVICES = 16
# the reference's distributed backends, not ported yet
DISTRIBUTED = ("dist", "dist-grid")


def register_backend(name: str, fn: Optional[BackendFn] = None):
    """Register ``fn`` under ``name``; usable as a decorator."""
    def _do(f: BackendFn) -> BackendFn:
        if not name or not isinstance(name, str):
            raise ValueError("backend name must be a non-empty str, "
                             f"got {name!r}")
        _REGISTRY[name] = f
        return f
    return _do(fn) if fn is not None else _do


def get_backend(name: str) -> BackendFn:
    if name in DISTRIBUTED and name not in _REGISTRY:
        raise NotImplementedError(
            f"backend {name!r}: the distributed engine is not ported to "
            "repro_torch yet (ROADMAP.md, queue 1 item 5); run with "
            "devices=1 or backend='single'")
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


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

@register_backend("single")
def _single(g: Graph, req, ctx: BackendContext) -> np.ndarray:
    return _single_partition(g, req.k, req.resolve_config(),
                             trace=ctx.trace,
                             level0_labels=ctx.level0_labels,
                             device=ctx.device)
