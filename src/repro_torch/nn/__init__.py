"""Transformer building blocks of the LM zoo (the counterpart of
``repro.nn``): ``layers`` (norm, dense, embedding, rotary, SwiGLU),
``attention`` (GQA self-attention with its plain, flash and banded
branches, the KV cache and decode attention), ``rglru`` (the Griffin
recurrent block) and, of ``ssm``, the causal convolution it runs.

Not ported yet: ``nn/moe.py`` and the rest of ``nn/ssm.py`` (their
families wait, ROADMAP Queue 1 item 15), and ``layer_norm`` /
``gelu_ffn`` (enc-dec).  ``nn/unroll.py`` has no counterpart: it sets
XLA's scan unrolling, and the port runs its loops eagerly.
"""
