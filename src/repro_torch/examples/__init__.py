"""The examples on the port (the counterparts of ``examples/``), each run
as ``python -m repro_torch.examples.<name> [--device cpu]`` (default
CUDA): ``quickstart``, ``cross_patient``, ``topology_async_ablation``
and ``serve_arch``.  Each keeps its body in ``main(argv)``, so importing
one runs nothing."""
