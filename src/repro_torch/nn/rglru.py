"""RG-LRU recurrent block of RecurrentGemma / Griffin (arXiv:2402.19427),
a port of ``repro.nn.rglru``.

Real-gated linear recurrent unit:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    a_t = a ^ (c * r_t),  a = sigmoid(Lambda)   (per-channel decay)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence h_t = a_t h_{t-1} + b_t runs over the whole sequence as a
log-depth scan (:func:`linear_scan`, in place of JAX's
``jax.lax.associative_scan``): ceil(log2 S) doubling steps, each a few
elementwise passes over (B, S, W) in fp32.  Decode is the O(1) one-step
update.  The JAX package has no Pallas kernel here, so this is plain
PyTorch.

Types follow JAX's op by op.  The gates run in fp32 on the input cast to
fp32; their weights, in the compute dtype after ``cast_params``, are
cast to fp32 for the product (JAX promotes the bf16 operand; torch's
matmul takes one dtype), while ``softplus(lam)`` runs in lam's own dtype,
op by op as JAX's does (:func:`softplus`), before it meets the fp32
gate.  TF32 stays off: the gate products are fp32.

On DTensors (the multi-GPU layout of ``arch/sharding.py``) the scan's
inputs are redistributed explicitly before it (``keep_batch``: sharded
on the channels beside the batch shard) and each rank scans its own
local shards, so that the doubling steps never slice a sharded dim.
Plain tensors scan directly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.arch.sharding import keep_batch, local_like
from repro_torch.nn.layers import normal
from repro_torch.nn.ssm import CONV_K, causal_conv
from repro_torch.utils.tracing import span

C_EXP = 8.0


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 from h_{-1} = 0: every
    prefix of JAX's ``combine((a1, b1), (a2, b2)) = (a1 a2, a2 b1 + b2)``,
    by ceil(log2 S) doubling steps (position t takes t - d at step d).
    a and b are not changed.  Without grad, two pairs of buffers take
    turns through ``out=`` writes; under autograd, which refuses
    ``out=``, each step concatenates the same products."""
    s = a.shape[1]
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        d = 1
        while d < s:
            a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                    torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1))
            d *= 2
        return b
    bufs = [(torch.empty_like(a), torch.empty_like(b)) for _ in range(2)]
    d, step = 1, 0
    while d < s:
        na, nb = bufs[step % 2]
        nb[:, :d] = b[:, :d]
        torch.addcmul(b[:, d:], a[:, d:], b[:, :-d], out=nb[:, d:])
        na[:, :d] = a[:, :d]
        torch.mul(a[:, d:], a[:, :-d], out=na[:, d:])
        a, b = na, nb
        d, step = 2 * d, step + 1
    return b


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as JAX computes it, op by op in x's dtype:
    max(x, 0) + log1p(exp(-|x|)).  In bf16 each op rounds, and
    ``F.softplus``, which rounds once, differs by an ulp."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _gates(xf: torch.Tensor, p: dict):
    """(a, sqrt(1 - a^2) * i * x) of fp32 input xf (..., W)."""
    r = torch.sigmoid(xf @ p["w_a"].float() + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].float() + p["b_x"])
    log_a = -C_EXP * r * softplus(p["lam"])
    a = torch.exp(log_a)
    return a, torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * xf)


def rglru_forward(x: torch.Tensor, p: dict, *, h0: torch.Tensor | None = None):
    """x (B, S, W) -> (y (B, S, W) in x's dtype, h_last (B, W) fp32)."""
    xf = x.float()
    a, gated = _gates(xf, p)
    if h0 is not None:
        gated[:, 0] += a[:, 0] * h0.float()
    with span("rglru.scan"):  # the profiler's span of the scan's passes
        if isinstance(a, DTensor):
            # channels sharded beside the batch: each rank scans its own
            a, gated = keep_batch(a, -1), keep_batch(gated, -1)
            h = DTensor.from_local(linear_scan(a.to_local(), local_like(gated, a, {0: 0, 2: 2})),
                                   a.device_mesh, a.placements, run_check=False)
        else:
            h = linear_scan(a, gated)
    return h.to(x.dtype), h[:, -1]


def rglru_decode_step(x_t: torch.Tensor, p: dict, h_prev: torch.Tensor):
    """x_t (B, W), h_prev (B, W) fp32 -> (y_t in x_t's dtype, h_new fp32)."""
    a, gated = _gates(x_t.float(), p)
    h_new = a * h_prev + gated
    return h_new.to(x_t.dtype), h_new


def init_rglru(gen: torch.Generator, width: int, dtype=torch.float32) -> dict:
    """JAX's distributions (not its numbers) from ``gen`` on its device:
    gate weights N(0, 1/W), zero biases, lam ~ U(0.3, 0.8)."""
    s = width ** -0.5

    def zeros():
        return torch.zeros((width,), dtype=dtype, device=gen.device)

    return {
        "w_a": normal(gen, (width, width), s, dtype),
        "b_a": zeros(),
        "w_x": normal(gen, (width, width), s, dtype),
        "b_x": zeros(),
        "lam": (torch.rand((width,), generator=gen, device=gen.device) * 0.5 + 0.3).to(dtype),
    }


# ---------------------------------------------------------------------------
# Griffin recurrent block: conv + RG-LRU + gated merge
# ---------------------------------------------------------------------------


def init_recurrent_block(gen: torch.Generator, d: int, width: int, dtype=torch.float32) -> dict:
    return {
        "w_in_x": normal(gen, (d, width), d ** -0.5, dtype),
        "w_in_gate": normal(gen, (d, width), d ** -0.5, dtype),
        "conv_w": normal(gen, (CONV_K, width), 0.2, dtype),
        "conv_b": torch.zeros((width,), dtype=dtype, device=gen.device),
        "rglru": init_rglru(gen, width, dtype),
        "w_out": normal(gen, (width, d), width ** -0.5, dtype),
    }


def recurrent_block(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Griffin recurrent block forward: x (B, S, d) -> (B, S, d)."""
    xb = x @ p["w_in_x"].to(x.dtype)
    gate = F.gelu(x @ p["w_in_gate"].to(x.dtype), approximate="tanh")
    y, _ = rglru_forward(causal_conv(xb, p["conv_w"], p["conv_b"]), p["rglru"])
    return (y * gate) @ p["w_out"].to(x.dtype)


def recurrent_block_decode(x_t: torch.Tensor, p: dict, state: dict):
    """One decode step: x_t (B, d), state {"conv": (B, K-1, W), "h": (B, W)}
    -> (out (B, d), new state); the given state is not changed."""
    xb = x_t @ p["w_in_x"].to(x_t.dtype)
    gate = F.gelu(x_t @ p["w_in_gate"].to(x_t.dtype), approximate="tanh")
    conv_in = torch.cat([state["conv"], xb[:, None, :]], dim=1)
    w = p["conv_w"].to(x_t.dtype)
    xb = F.silu(torch.einsum("bkc,kc->bc", conv_in, w) + p["conv_b"].to(x_t.dtype))
    y, h_new = rglru_decode_step(xb, p["rglru"], state["h"])
    return (y * gate) @ p["w_out"].to(x_t.dtype), {"conv": conv_in[:, 1:], "h": h_new}


def init_recurrent_state(batch: int, width: int, dtype=torch.float32, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, CONV_K - 1, width), dtype=dtype, device=device),
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
    }
