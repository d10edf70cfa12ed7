"""Granite-3.0-1B-A400M (fine-grained MoE: 32 experts top-8).

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d_model=1024 16H
(GQA kv=8) d_ff=512 (per expert) vocab=49155, 32 experts top-8.
Expert dim (32) divides the 16-way model axis -> expert-parallel
sharding.  Full attention: long_500k SKIPPED.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("granite-moe-1b-a400m")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,
        vocab_size=49155,
        num_experts=32,
        experts_per_token=8,
    )
