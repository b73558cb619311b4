from .format import Graph, from_coo, induced_subgraph, permute
from . import generators

__all__ = ["Graph", "from_coo", "induced_subgraph", "permute", "generators"]
