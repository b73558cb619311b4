"""The models the placement engine places — port of ``repro.models``:
the GNNs (``gnn/``: GAT, SchNet, NequIP, DimeNet) and DLRM (``dlrm``),
forward passes only, over the substrate of ``common``. Each model is a
``build_specs(cfg)`` spec tree and a functional ``forward(params, batch,
cfg, ctx)`` whose parameter keys are the reference's spec keys."""
