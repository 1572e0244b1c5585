"""The benchmark of ``refvsr_tpu_torch``, the PyTorch and CUDA port of
RefVSR, on NVIDIA H100 cards. ``BENCHMARK.json`` at the repository's root
lists its cells; ``python3 benchmark/run.py`` runs one (``core.py``)."""
