"""The benchmark of the PyTorch and CUDA port (``tpudp_torch``).

``run.py`` runs one cell; BENCHMARK.json at the repository's root names
the cells, configurations and metrics, each backed by a file here.
"""
