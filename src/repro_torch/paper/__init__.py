"""The paper's experiments on the port (the counterparts of
``benchmarks/`` under the same file names): Table 2 (GluADFL's
generalization), Table 3 (mixed-data supervised training), Table 4 (all
population methods against each other, seen and unseen patients) and
Fig 3 (personalization), on their shared engine ``paper.common``.  Each
runs as ``python -m repro_torch.paper.<name> [--device cpu] [--full]``
and writes its JSON under ``experiments/paper_torch/``."""
