"""Mamba2-370m (attention-free SSM, SSD / state-space duality).

[arXiv:2405.21060] 48L d_model=1024 (attn-free) vocab=50280,
ssm_state=128.  d_inner = 2*d = 2048, 32 heads of headdim 64, 1 B/C
group.  O(1) decode state -> long_500k runs.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("mamba2-370m")
def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m",
        family="ssm",
        citation="arXiv:2405.21060",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_heads=32,
        ssm_expand=2,
        ssm_chunk=64,
    )
