"""Hand-written CUDA kernels of the main path (sources in ``csrc/``), each
beside its plain PyTorch version (``ref.py``) and its host-side wiring
(``ops.py``)."""
