"""Partitioning facade of the port — the one public surface:

    from repro_torch.api import GraphSpec, PartitionRequest, Partitioner

    req = PartitionRequest(graph=GraphSpec("rgg2d", 2**20), k=16)
    res = Partitioner(backend="single").run(req)     # on the CUDA device
    res.assignment, res.feasible, res.metrics, res.trace
"""
from .backends import (BackendContext, available_backends, get_backend,
                       register_backend, resolve_backend)
from .partitioner import Partitioner, partition
from .request import GraphSpec, PartitionRequest
from .result import PartitionResult

__all__ = ["BackendContext", "GraphSpec", "PartitionRequest",
           "PartitionResult", "Partitioner", "available_backends",
           "get_backend", "partition", "register_backend",
           "resolve_backend"]
