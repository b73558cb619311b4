"""String-keyed backend registry for the partitioning facade — port of
``repro.api.backends``.

A backend is a callable ``(g, req, ctx) -> assignment`` where ``ctx`` is
a ``BackendContext`` carrying the torch device, an optional trace list
``partition`` appends per-level records to, and optional precomputed
level-0 labels. This slice of the port registers ``single`` (the
single-process deep MGP of ``core.deep_mgp``); the distributed backends
and the baselines are later slices.
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
    """The ``auto`` policy of this slice: ``single``."""
    return "single" if req.backend == "auto" else req.backend


# ---------------------------------------------------------------------------
# built-in backends
# ---------------------------------------------------------------------------

@register_backend("single")
def _single(g: Graph, req, ctx: BackendContext) -> np.ndarray:
    return _single_partition(g, req.k, req.resolve_config(),
                             trace=ctx.trace,
                             level0_labels=ctx.level0_labels,
                             device=ctx.device)
