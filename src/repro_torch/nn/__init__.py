"""Transformer building blocks of the LM zoo (the counterpart of
``repro.nn``): ``layers`` (norm, dense, embedding, rotary, SwiGLU) and
``attention`` (GQA self-attention with its plain, flash and banded
branches, the KV cache and decode attention).

Not ported yet: ``nn/moe.py`` and ``nn/rglru.py`` (their families wait,
ROADMAP Queue 1 item 15), and ``layer_norm`` / ``gelu_ffn`` (enc-dec).
``nn/unroll.py`` has no counterpart: it sets XLA's scan unrolling, and
the port runs its loops eagerly.
"""
