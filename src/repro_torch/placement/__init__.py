"""Placement engine: the paper's partitioner as the device-placement
oracle for GNN graphs, DLRM tables and MoE experts — port of
``repro.placement``. Each ``plan`` partitions on the card unless
``device="cpu"`` is asked for."""
