"""Partitioning facade of the port — the one public surface:

    from repro_torch.api import GraphSpec, PartitionRequest, Partitioner

    req = PartitionRequest(graph=GraphSpec("rgg2d", 2**20), k=16)
    res = Partitioner(backend="single").run(req)     # on the CUDA device
    res.assignment, res.feasible, res.metrics, res.trace

Backends ("single", plus the paper's baselines "plain_mgp" /
"single_level_lp") live in a string-keyed registry;
``Partitioner.compare`` runs one request against several of them, and
``PartitionSession`` serves batches of requests on one device, and
distributed ones on a mesh of rank processes (``runtime.PeMesh``).
"""
from .backends import (BackendContext, available_backends, get_backend,
                       is_batchable, register_backend, resolve_backend)
from .partitioner import Partitioner, partition
from .request import GraphSpec, PartitionRequest
from .result import PartitionResult
from .session import BucketCache, PartitionSession

__all__ = ["BackendContext", "BucketCache", "GraphSpec", "PartitionRequest",
           "PartitionResult", "PartitionSession", "Partitioner",
           "available_backends", "get_backend", "is_batchable", "partition",
           "register_backend", "resolve_backend"]
