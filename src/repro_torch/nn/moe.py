"""Mixture-of-Experts FFN with capacity-based expert-side dispatch (a
port of ``repro.nn.moe``).

Per batch row: a router softmax over E experts in fp32, token-side top-k
(every expert tied with the k-th kept, then renormalised), and each
expert takes its top-C tokens by router priority, C = S·k/E ·
capacity_factor, as JAX computes it.  The experts' gated MLPs run
batched over E (``torch.matmul``, as JAX's einsums run outside any
Pallas kernel) and their outputs, weighted by the gate values, are added
back at the tokens' positions.  Over-capacity tokens are dropped (GShard
semantics).  At decode (S=1) C is 1: every expert runs the one token and
those it was not routed to add 0, as in JAX.

Two choices keep the port on JAX's result:

  * the expert-side choice is a stable descending sort, so tied
    priorities go to the lower token index as ``jax.lax.top_k`` breaks
    them (``torch.topk`` promises no order among ties, and ties are
    common: a prompt of one repeated token ties every priority at the
    first layer);
  * the combine is one ``index_add_`` an expert, in expert order: the C
    positions of one expert are distinct, so no two atomics of one call
    meet on the card, the result repeats bit for bit, and a token
    reached by several experts sums them in JAX's order.

Aux losses (load balance, router z-loss) are returned as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.nn.layers import normal


def init_moe(gen: torch.Generator, d: int, ff: int, num_experts: int,
             dtype=torch.float32) -> dict:
    e = num_experts
    return {
        "router": normal(gen, (d, e), d ** -0.5, dtype),
        "w_gate": normal(gen, (e, d, ff), d ** -0.5, dtype),
        "w_up": normal(gen, (e, d, ff), d ** -0.5, dtype),
        "w_down": normal(gen, (e, ff, d), ff ** -0.5, dtype),
    }


def capacity(s: int, top_k: int, num_experts: int, capacity_factor: float) -> int:
    """Tokens an expert takes per batch row (JAX's Python expression)."""
    return min(max(1, int(s * top_k / num_experts * capacity_factor)), s)


def expert_choice(routed: torch.Tensor, cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each expert's top-``cap`` tokens by priority: routed (B, S, E) ->
    (gate values (B, E, C), token indices (B, E, C)), ties to the lower
    index as ``jax.lax.top_k``."""
    vals, idx = torch.sort(routed.transpose(1, 2), dim=-1, descending=True, stable=True)
    return vals[..., :cap], idx[..., :cap]


def moe_ffn(x: torch.Tensor, p: dict, *, top_k: int,
            capacity_factor: float = 1.25) -> tuple[torch.Tensor, dict]:
    """x (B, S, d) -> (out (B, S, d) in x's dtype, {"load_balance",
    "router_z"} fp32 scalars)."""
    with record_function("moe"):  # the profiler's span of the layer's MoE
        return _moe_ffn(x, p, top_k, capacity_factor)


def _moe_ffn(x, p, top_k, capacity_factor):
    b, s, d = x.shape
    e = p["router"].shape[1]
    logits = x.float() @ p["router"].float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)

    # token-side top-k: every expert at least as likely as the k-th
    kth = torch.topk(probs, top_k, dim=-1).values[..., -1:]
    routed = torch.where(probs >= kth, probs, torch.zeros((), device=x.device))
    routed = routed / torch.clamp(routed.sum(dim=-1, keepdim=True), min=1e-9)

    gate_vals, token_idx = expert_choice(routed, capacity(s, top_k, e, capacity_factor))
    # expert-major (E, B·C) rows, so that each expert is one GEMM whatever B
    rows = (token_idx + (torch.arange(b, device=x.device) * s)[:, None, None]).transpose(0, 1)
    rows = rows.reshape(e, -1)
    xin = x.reshape(b * s, d)[rows]  # (E, B·C, d)
    h = F.silu(torch.bmm(xin, p["w_gate"].to(x.dtype))) * torch.bmm(xin, p["w_up"].to(x.dtype))
    xo = torch.bmm(h, p["w_down"].to(x.dtype))
    xo = xo * gate_vals.transpose(0, 1).reshape(e, -1, 1).to(x.dtype)

    out = torch.zeros((b * s, d), dtype=x.dtype, device=x.device)
    for j in range(e):
        out.index_add_(0, rows[j], xo[j])

    me = probs.mean(dim=(0, 1))
    ce = (routed > 0).float().mean(dim=(0, 1)) * e / top_k
    load_balance = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return out.reshape(b, s, d), {"load_balance": load_balance, "router_z": z_loss}
