"""gpubench: the benchmark of the PyTorch and CUDA port, ``mcraw_torch``, on
one card. ``python3 -m gpubench.run`` runs one cell of ``BENCHMARK.json``;
see ``gpubench/README.md``."""
