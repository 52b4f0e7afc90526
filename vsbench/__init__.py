"""The benchmark of vectorsearch_tpu_torch on one NVIDIA H100: the cells of
BENCHMARK.json, their inputs made from a seed, the plain reference that
decides `correct`, and the per-layer readers. `python3 -m vsbench.run`."""
