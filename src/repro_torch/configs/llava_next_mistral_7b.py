"""LLaVA-NeXT (Mistral-7B backbone) — VLM family.

[hf:llava-hf/llava-v1.6-mistral-7b-hf] 32L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=32000.  The anyres-tiling ViT/CLIP vision encoder +
projector frontend is a STUB: input_specs supplies patch embeddings
(vision_tokens=2048 anyres tokens).  Mistral backbone sliding window
(4096) -> long_500k runs.
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("llava-next-mistral-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="llava-next-mistral-7b",
        family="vlm",
        citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        sliding_window=4096,
        vision_tokens=2048,
        rope_theta=1e6,
    )
