"""Mixtral-8x22B (sparse MoE, 8 experts top-2, SWA).

[arXiv:2401.04088] 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2.  Sliding window per the Mixtral model
card -> long_500k runs.  Expert count (8) < model axis (16): expert
weights shard their hidden dim; granite (32e) shards the expert dim.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("mixtral-8x22b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        citation="arXiv:2401.04088",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=16384,
        vocab_size=32768,
        num_experts=8,
        experts_per_token=2,
        sliding_window=4096,
        rope_theta=1e6,
    )
