"""Mistral-Large-Instruct-2407 (123B dense GQA).

[hf:mistralai/Mistral-Large-Instruct-2407] 88L d_model=12288 96H
(GQA kv=8) d_ff=28672 vocab=32768.  Sliding-window variant (w=4096,
Mistral-family signature mechanism) enables the long_500k shape.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("mistral-large-123b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mistral-large-123b",
        family="dense",
        citation="hf:mistralai/Mistral-Large-Instruct-2407",
        num_layers=88,
        d_model=12288,
        num_heads=96,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=32768,
        sliding_window=4096,
        rope_theta=1e6,
    )
