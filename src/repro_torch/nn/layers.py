"""Basic transformer layers as plain functions over tensors (a copy of
``repro.nn.layers``).

Conventions, as in the JAX package: activations (B, S, D), attention
heads (B, S, H, hd), ``dense(x, w)`` with ``w`` (d_in, d_out), and every
vocabulary-sized dimension padded to a multiple of 128 (``pad_vocab``).
The ``init_*`` helpers draw from a ``torch.Generator`` (the same
distributions as JAX's, not the same numbers).

The norms' outputs go through ``arch.sharding.constrain_act`` (the
identity on plain tensors and without a policy): on DTensors a norm's
output is pinned to the residual stream's layout (batch on the data
axes, d whole), which DTensor would otherwise leave split on d, so that
the projection after it takes its weight's column split (Megatron's
layout, as GSPMD chooses it) instead of gathering the weight.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.arch.sharding import constrain_act, resolve_partial


def pad_vocab(v: int, multiple: int = 128) -> int:
    return -(-v // multiple) * multiple


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in fp32 with the (1 + scale) gain, back in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return constrain_act((xf * torch.rsqrt(var + eps) * (1.0 + scale.float())).to(x.dtype))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm in fp32 (population variance), back in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return constrain_act((y * scale.float() + bias.float()).to(x.dtype))


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        # (on DTensors a row-split product's pending sums are reduced
        # before the bias, which may be sharded itself)
        y = resolve_partial(y) + b.to(x.dtype)
    return y


def embed(tokens: torch.Tensor, table: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(table, DTensor):
        # the table's vocab shards gathered first: DTensor's masked-sum
        # rule for a split vocab cannot be reduced twice (a layer's
        # recomputation under remat) and some torch releases cannot
        # turn its gradient back; its advanced-indexing rule fails in
        # some releases' backward
        whole = [Replicate() if isinstance(p, Shard) and p.dim == 0 else p
                 for p in table.placements]
        if whole != list(table.placements):
            table = table.redistribute(table.device_mesh, whole)
        return F.embedding(tokens.long(), table).to(dtype)
    return table[tokens.long()].to(dtype)


def rope(x: torch.Tensor, positions, theta: float = 1e4) -> torch.Tensor:
    """Rotary embedding, halves rotated.  x (B, S, H, hd); positions
    (B, S) or (S,), a tensor or a sequence of ints."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    positions = torch.as_tensor(positions, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].float() * freq  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 on the generator's device, then
    cast to ``dtype``."""
    return (torch.randn(shape, generator=gen, device=gen.device) * scale).to(dtype)


def init_swiglu(gen: torch.Generator, d: int, ff: int, dtype=torch.float32) -> dict:
    return {
        "w_gate": normal(gen, (d, ff), d ** -0.5, dtype),
        "w_up": normal(gen, (d, ff), d ** -0.5, dtype),
        "w_down": normal(gen, (ff, d), ff ** -0.5, dtype),
    }


def swiglu_ffn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Gated MLP (gate, up, down), llama/mistral style."""
    return dense(F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"]), p["w_down"])


def init_gelu_ffn(gen: torch.Generator, d: int, ff: int, dtype=torch.float32) -> dict:
    return {
        "w_in": normal(gen, (d, ff), d ** -0.5, dtype),
        "b_in": torch.zeros((ff,), dtype=dtype, device=gen.device),
        "w_out": normal(gen, (ff, d), ff ** -0.5, dtype),
        "b_out": torch.zeros((d,), dtype=dtype, device=gen.device),
    }


def gelu_ffn(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Plain two-matrix MLP with the tanh GELU (whisper style)."""
    h = F.gelu(dense(x, p["w_in"], p["b_in"]), approximate="tanh")
    return dense(h, p["w_out"], p["b_out"])
