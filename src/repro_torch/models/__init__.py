"""The models of the port — of ``repro.models``: the decoder-only
transformer LM (``transformer``: prefill, loss value and KV-cache
decode), the GNNs the placement engine places (``gnn/``: GAT, SchNet,
NequIP, DimeNet) and DLRM (``dlrm``), forward passes only, over the
substrate of ``common``. Each model is a ``build_specs(cfg)`` spec tree
and functional passes over dicts of tensors whose keys are the
reference's spec keys."""
from . import transformer  # noqa: F401
