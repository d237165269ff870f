"""portbench: the benchmark of ``pyipm_tpu_torch`` on an NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  Everything that belongs to one configuration, traffic mix,
cell or per-layer metric is a file of its own, found by its name
(``registry.py``).  Nothing here imports ``jax`` or the JAX package.
"""
