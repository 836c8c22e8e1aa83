"""The benchmark of ``bevy_hanabi_tpu_torch`` on one NVIDIA H100.

``python3 -m hanabi_bench.run`` runs one cell of ``BENCHMARK.json``; the
README in this folder says how cells, configurations, traffic mixes,
limits, metrics and references are added. Importing this package imports
neither the program nor JAX."""
