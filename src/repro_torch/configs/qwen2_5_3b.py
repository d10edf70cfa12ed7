"""Qwen2.5-3B (dense GQA with QKV bias).

[hf:Qwen/Qwen2.5-0.5B family card] 36L d_model=2048 16H (GQA kv=2)
d_ff=11008 vocab=151936, QKV bias.  Full attention: long_500k SKIPPED.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("qwen2.5-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2.5-3b",
        family="dense",
        citation="hf:Qwen/Qwen2.5-0.5B (2.5 family)",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        attn_bias=True,
        rope_theta=1e6,
    )
