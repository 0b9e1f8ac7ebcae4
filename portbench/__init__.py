"""The benchmark of ``canny_edge_tpu_torch`` on the card: ``run.py`` runs one
cell of ``BENCHMARK.json``."""
