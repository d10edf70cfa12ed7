"""Dispatch between the port's CUDA kernels and their plain twins (the
counterpart of ``repro.kernels.ops``).

A tensor on a CUDA device goes to the kernel, which launches or raises;
a tensor on the CPU goes to the plain twin.  There is no fallback from
one to the other, and no padding of rows or columns: the LSTM and
gossip kernels mask any shape, and ``swa_attention``'s kernel refuses
S % 64 != 0 (its twin takes any S) and zero-pads only the head dim (to
64, 128, 256 or a multiple of 256), unlike ``repro.kernels.ops``,
which pads N to 8 rows and D to 512 columns, falls back to the reference
LSTM cell when ``H % 128 != 0`` and refuses an attention length
S % 128 != 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gossip_mix as gossip_kernels
from repro_torch.kernels import lstm_cell, lstm_train
from repro_torch.kernels import ref
from repro_torch.kernels import swa_attention as swa_kernel


def _route(name: str, t: torch.Tensor, kernel, plain):
    if t.device.type == "cuda":
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"{name} runs on CUDA or the CPU, not {t.device}")


def lstm_forward(x, wx, wh, b, w_out, b_out) -> torch.Tensor:
    """L LSTM steps plus the linear head with per-group weights:
    x (G, R, L, I) -> y (G, R); see ``kernels/lstm_cell.py``."""
    fn = _route("lstm_forward", x, lstm_cell.lstm_forward, ref.lstm_forward_plain)
    return fn(x, wx, wh, b, w_out, b_out)


def lstm_gates_fwd(gates, x, wx, b, c_prev, c, h) -> None:
    """Step t of the trainer's LSTM forward, in place on ``gates``, ``c``
    and ``h``; see ``kernels/lstm_train.py``."""
    fn = _route("lstm_gates_fwd", gates, lstm_train.lstm_gates_fwd, ref.lstm_gates_fwd_plain)
    fn(gates, x, wx, b, c_prev, c, h)


def lstm_gates_bwd(gates, c_prev, c, dh, dc, x, db, dwx, accumulate: bool) -> None:
    """Step t of the trainer's LSTM backward, in place on ``gates``,
    ``dc``, ``db`` and ``dwx``; see ``kernels/lstm_train.py``."""
    fn = _route("lstm_gates_bwd", gates, lstm_train.lstm_gates_bwd, ref.lstm_gates_bwd_plain)
    fn(gates, c_prev, c, dh, dc, x, db, dwx, accumulate)


def gossip_mix(mix, w, active) -> torch.Tensor:
    """Dense gossip mix with the active-row select (N, D) -> (N, D)."""
    fn = _route("gossip_mix", w, gossip_kernels.gossip_mix, ref.gossip_mix_plain)
    return fn(mix, w, active)


def gossip_mix_sparse(idx, wgt, w, active) -> torch.Tensor:
    """Neighbor-table gossip mix with the active-row select."""
    fn = _route("gossip_mix_sparse", w, gossip_kernels.gossip_mix_sparse,
                ref.gossip_mix_sparse_plain)
    return fn(idx, wgt, w, active)


def gossip_mix_dp(mix, w, z, active) -> torch.Tensor:
    """Dense local-DP gossip (z: the scaled noise)."""
    fn = _route("gossip_mix_dp", w, gossip_kernels.gossip_mix_dp, ref.gossip_mix_dp_plain)
    return fn(mix, w, z, active)


def gossip_mix_sparse_dp(idx, wgt, w, z, active) -> torch.Tensor:
    """Sparse local-DP gossip (z: the scaled noise)."""
    fn = _route("gossip_mix_sparse_dp", w, gossip_kernels.gossip_mix_sparse_dp,
                ref.gossip_mix_sparse_dp_plain)
    return fn(idx, wgt, w, z, active)


def swa_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Causal sliding-window attention: q (B, S, H, hd), k and v
    (B, S, K, hd) with H % K == 0 (KV heads not repeated) -> (B, S, H, hd);
    see ``kernels/swa_attention.py``."""
    fn = _route("swa_attention", q, swa_kernel.swa_attention, ref.swa_attention_plain)
    return fn(q, k, v, window=window)
