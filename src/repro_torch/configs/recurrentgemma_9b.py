"""RecurrentGemma-9B (hybrid: RG-LRU + local attention, 1 attn : 2 rec).

[arXiv:2402.19427] 38L d_model=4096 16H (GQA kv=1 = MQA) d_ff=12288
vocab=256000, local attention window 2048.  38 layers / pattern length
3 -> 13 super-blocks = 39 effective layers (DESIGN.md §4 note).
Recurrent state + ring local-attn cache -> long_500k runs.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("recurrentgemma-9b")
def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        citation="arXiv:2402.19427",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "attn"),
        lru_width=4096,
        local_attn_window=2048,
    )
