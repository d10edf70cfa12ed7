"""Typed configuration dataclasses and dotted-override parsing
(``a.b=c``), copied from ``repro.config`` without the architecture
registry; see ``config/base.py``."""
from repro_torch.config.base import (
    DataConfig,
    ExperimentConfig,
    FLConfig,
    TrainConfig,
    apply_overrides,
)
