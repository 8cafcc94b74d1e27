"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100:
``run.py`` runs one cell of ``BENCHMARK.json`` once. See PERF.md."""
