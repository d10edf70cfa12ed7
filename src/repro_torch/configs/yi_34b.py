"""Yi-34B (dense, llama-architecture GQA).

[arXiv:2403.04652] 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000.  Pure full attention: long_500k SKIPPED (DESIGN.md §4).
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("yi-34b")
def config() -> ArchConfig:
    return ArchConfig(
        name="yi-34b",
        family="dense",
        citation="arXiv:2403.04652",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5e6,
    )
