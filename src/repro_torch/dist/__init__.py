"""Distributed subsystem (paper §4–5) — port of ``repro.dist`` onto
``torch.distributed``: sparse all-to-all collectives over a process group
(``collectives``), distributed LP clustering and refinement (``dist_lp``),
sharded contraction (``dist_contraction``), the distributed balancer
(``dist_balance``) and the distributed deep-MGP driver
(``dist_partitioner``). One rank a PE; every rank runs the same host code
and returns the same result.

Nothing here initialises a process group at import; the engine functions
take a ``PeGroup`` (or the initialised default group's, see
``api.runtime.distributed_init``); ``dist_lp.make_mesh_1d`` spawns a
mesh of rank processes that runs them for a serving process.
``sharding`` holds the named-axis rules of the model layers; it is
dependency-light, and models import it at module load.
"""
from .collectives import PeGroup, grid_factors, world_group
from .sharding import (DEFAULT_RULES, NULL_CTX, ShardCtx, resolve_axes,
                       spec_shardings)

__all__ = ["DEFAULT_RULES", "NULL_CTX", "PeGroup", "ShardCtx",
           "grid_factors", "resolve_axes", "spec_shardings", "world_group"]
