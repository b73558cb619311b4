"""Hand-written CUDA kernels (sources in ``csrc/``): the four of the main
path and the three standalone micro-kernels (``lp_gain``, ``bsr_spmm``,
``embedding_bag``), each beside its plain PyTorch version (``ref.py``)
and its host-side wiring (``ops.py``)."""
