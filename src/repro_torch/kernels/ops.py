"""Dispatch between the port's CUDA kernels and their plain twins (the
counterpart of ``repro.kernels.ops``).

A tensor on a CUDA device goes to the kernel, which launches or raises;
a tensor on the CPU goes to the plain twin.  There is no fallback from
one to the other, and no padding: the kernel masks any H, unlike
``repro.kernels.ops.lstm_cell``, which falls back to the reference when
``H % 128 != 0``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import lstm_cell
from repro_torch.kernels.ref import lstm_forward_plain


def lstm_forward(x, wx, wh, b, w_out, b_out) -> torch.Tensor:
    """L LSTM steps plus the linear head with per-group weights:
    x (G, R, L, I) -> y (G, R); see ``kernels/lstm_cell.py``."""
    if x.device.type == "cuda":
        return lstm_cell.lstm_forward(x, wx, wh, b, w_out, b_out)
    if x.device.type == "cpu":
        return lstm_forward_plain(x, wx, wh, b, w_out, b_out)
    raise ValueError(f"lstm_forward runs on CUDA or the CPU, not {x.device}")
