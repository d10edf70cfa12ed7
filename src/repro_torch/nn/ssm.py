"""Pieces of the Mamba-2 SSD layer (a port of part of ``repro.nn.ssm``).

Only the depthwise causal convolution is here so far: the RG-LRU
recurrent block (``nn/rglru.py``) runs it, as the JAX package's does.
The SSD scan itself (``ssd_forward``, ``ssd_decode_step``,
``mamba2_block``, ``mamba2_decode``) waits for the SSM family (ROADMAP
Queue 1 item 15.2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

CONV_K = 4


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of kernel ``w.shape[0]``, then SiLU, in u's
    dtype (``repro.nn.ssm._causal_conv``): u (B, S, C), w (K, C), b (C,).
    Position t sums ``u[t - K + 1 + i] * w[i]`` over i in order, with
    zeros before the start."""
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * w[i].to(u.dtype) for i in range(k))
    return F.silu(out + b.to(u.dtype))
