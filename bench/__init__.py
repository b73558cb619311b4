"""The benchmark of ``repro_torch``, the partitioner's PyTorch and CUDA
port: ``python3 bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON line. Imports neither JAX nor the JAX package ``repro``.
"""
