"""Carry the input state from the JAX package's objects into the port's.

The partitioner has no weights; what crosses over is the input: a graph
(the reference ``Graph``'s four CSR fields as numpy arrays), a
distributed graph (a reference ``GraphShards``' fields), a configuration
(``dataclasses.asdict`` of a reference ``PartitionerConfig``: the
distributed memory model's ``contraction`` / ``balance`` / ``weights``
are among its fields) and a request (its fields: ``backend`` carries the
routing of the distributed engine's collectives, ``dist-grid`` being the
reference's ``use_grid=True``). Tests hand both packages the same input, and the
serving tests the same traffic, through these, without this package
importing the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from .core.deep_mgp import PartitionerConfig
from .graphs.distribute import GraphShards
from .graphs.format import Graph


def graph_from_arrays(indptr, adjncy, eweights, vweights) -> Graph:
    """The port's ``Graph`` over copies of the four CSR arrays."""
    return Graph(indptr=np.array(indptr, dtype=np.int64),
                 adjncy=np.array(adjncy),
                 eweights=np.array(eweights, dtype=np.int64),
                 vweights=np.array(vweights, dtype=np.int64))


def config_from_dict(d: Mapping[str, Any]) -> PartitionerConfig:
    """The port's ``PartitionerConfig`` from a reference config's fields;
    an unknown field raises ``TypeError``."""
    return PartitionerConfig(**dict(d)).validate()


def shards_from(shards) -> GraphShards:
    """The port's ``GraphShards`` over copies of a reference
    ``GraphShards``' fields (any object with them)."""
    return GraphShards(**{
        f.name: (np.array(getattr(shards, f.name))
                 if isinstance(getattr(shards, f.name), np.ndarray)
                 else int(getattr(shards, f.name)))
        for f in dataclasses.fields(GraphShards)})


def request_from_fields(fields: Mapping[str, Any]):
    """The port's ``PartitionRequest`` from a reference request's fields
    (``{f.name: getattr(req, f.name) for f in dataclasses.fields(req)}``).

    ``graph`` is a generator spec (its ``family``, ``n``, ``avg_deg``
    and ``seed``) or a graph (its CSR arrays are copied); ``config``, if
    set, a config dataclass (its fields are copied). Every other field
    (k, epsilon, preset, seed, backend, devices, refine, quality, ...)
    crosses as it is."""
    from .api.request import GraphSpec, PartitionRequest

    f = dict(fields)
    g = f.pop("graph")
    if hasattr(g, "family"):
        graph = GraphSpec(g.family, g.n, g.avg_deg, g.seed)
    else:
        graph = graph_from_arrays(g.indptr, g.adjncy, g.eweights,
                                  g.vweights)
    if f.get("config") is not None:
        f["config"] = config_from_dict(dataclasses.asdict(f["config"]))
    return PartitionRequest(graph=graph, **f)
