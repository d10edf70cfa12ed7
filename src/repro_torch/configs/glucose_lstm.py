"""The paper's own model: single-layer LSTM glucose predictor.

Not part of the assigned-architecture pool; registered so the launcher
can select the paper's experiment with ``--arch glucose-lstm``.
[GluADFL paper, §3.2; hidden sweep {128, 256, 512}]
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("glucose-lstm")
def config() -> ArchConfig:
    return ArchConfig(
        name="glucose-lstm",
        family="lstm",
        citation="GluADFL (Piao et al., 2024), §3.2",
        num_layers=1,
        d_model=128,       # LSTM hidden size (paper's best-performing 128)
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=0,
        dtype="float32",
    )
