"""The benchmark of the PyTorch/CUDA port ``repro_torch`` (see
``BENCHMARK.json`` at the repository root and ``bench/run.py``)."""
