"""Yi-6B (dense, llama-architecture GQA).

[arXiv:2403.04652] 32L d_model=4096 32H (GQA kv=4) d_ff=11008
vocab=64000.  Full attention: long_500k SKIPPED.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("yi-6b")
def config() -> ArchConfig:
    return ArchConfig(
        name="yi-6b",
        family="dense",
        citation="arXiv:2403.04652",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        rope_theta=5e6,
    )
