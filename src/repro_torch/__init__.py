"""repro_torch: dKaMinPar (Distributed Deep Multilevel Graph Partitioning)
on PyTorch and CUDA for an NVIDIA H100 — the port of the JAX package
``repro``, which stays the reference. Imports torch, numpy and scipy only.
"""
__version__ = "0.1.0"
