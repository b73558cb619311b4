"""The plain versions that decide ``correct``: NumPy and PyTorch only,
nothing of the program and nothing of JAX."""
