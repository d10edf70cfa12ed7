"""Typed configuration dataclasses, the architecture registry and
dotted-override parsing (``a.b=c``), copied from ``repro.config``; see
``config/base.py``."""
from repro_torch.config.base import (
    ArchConfig,
    DataConfig,
    ExperimentConfig,
    FLConfig,
    SweepConfig,
    TrainConfig,
    apply_overrides,
    get_arch_config,
    list_archs,
    register_arch,
)
