"""Carry the input state from the JAX package's objects into the port's.

The partitioner has no weights; what crosses over is the input: a graph
(the reference ``Graph``'s four CSR fields as numpy arrays) and a
configuration (``dataclasses.asdict`` of a reference
``PartitionerConfig``). Tests hand both packages the same input through
these, without this package importing the reference.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from .core.deep_mgp import PartitionerConfig
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
