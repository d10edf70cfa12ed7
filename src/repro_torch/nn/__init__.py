"""Transformer building blocks of the LM zoo (the counterpart of
``repro.nn``): ``layers`` (RMS and layer norm, dense, embedding, rotary, SwiGLU and
GELU MLPs), ``attention`` (GQA self-attention with its plain, flash and
banded branches, the KV cache and decode attention), ``moe`` (the
capacity-dispatched mixture of experts), ``ssm`` (Mamba-2's chunked SSD,
its block and its decode step, and the causal convolution) and
``rglru`` (the Griffin recurrent block).

``nn/unroll.py`` has no counterpart: it sets XLA's scan unrolling, and
the port runs its loops eagerly.
"""
