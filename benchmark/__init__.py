"""The PyTorch/CUDA port's benchmark: one cell a run, driven by
``BENCHMARK.json`` at the repository's root (see ``run.py``)."""
