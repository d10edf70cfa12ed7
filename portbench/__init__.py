"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): its
harness, traffic generator, plain reference, trace reduction and metric
readers.  ``BENCHMARK.json`` at the repository root lists its cells; the
command is ``python3 portbench/run.py`` (``harness.py``)."""
