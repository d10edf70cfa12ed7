"""Whisper-medium (audio encoder-decoder).

[arXiv:2212.04356] 24+24L d_model=1024 16H (MHA) d_ff=4096 vocab=51865.
Mel-spectrogram + conv frontend is a STUB: input_specs supplies
precomputed frame embeddings (B, 1500, d).  Full-attention decoder:
long_500k SKIPPED (DESIGN.md §4).
"""
from repro_torch.config import ArchConfig, register_arch


@register_arch("whisper-medium")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-medium",
        family="encdec",
        citation="arXiv:2212.04356",
        num_layers=24,
        encoder_layers=24,
        encoder_seq=1500,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51865,
        tie_embeddings=True,
    )
