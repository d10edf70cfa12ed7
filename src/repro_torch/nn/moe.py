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
  * the combine is one ``scatter_add_`` an expert, in expert order,
    along the sequence of each batch row: the C positions of one expert
    in a row are distinct, so no two atomics of one call meet on the
    card, the result repeats bit for bit, and a token reached by several
    experts sums them in JAX's order.

The tokens are gathered (``torch.gather`` along the sequence) and added
back per batch row, so that on DTensor inputs (the multi-GPU layout of
``arch/sharding.py``) a batch shard stays on its rank: DTensor has no
rule for ``index_add_`` or for flattening a sharded batch into the
rows.  One explicit redistribution there: the experts' outputs are
gathered to every expert on each rank before the combine
(:func:`combine`); the aux losses' means over the sharded batch are
reduced at once (``arch.sharding.resolve_partial``).  Plain tensors take
the same ops, the redistribution aside.  Against the flat-row form
(indexed rows of the (B·S, d) activations, one ``index_add_`` an
expert), on an NVIDIA H100 80GB HBM3 at 700 W
(``tools/moe_dispatch_ab.py``): Mixtral-8x22B's 32,768-token prefill
layer 2.90 ms against 5.24; a Granite-MoE train microbatch's layer,
forward and backward, 9.76 ms against 9.15, and its input gradient
(the gather's backward adds with atomics where experts share a token)
does not repeat bit for bit on the card.

Aux losses (load balance, router z-loss) are returned as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.arch.sharding import resolve_partial
from repro_torch.nn.layers import normal
from repro_torch.utils.tracing import span


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
    with span("moe"):  # the profiler's span of the layer's MoE
        return _moe_ffn(x, p, top_k, capacity_factor)


def _moe_ffn(x, p, top_k, capacity_factor):
    s = x.shape[1]
    e = p["router"].shape[1]
    logits = x.float() @ p["router"].float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)

    # token-side top-k: every expert at least as likely as the k-th
    kth = torch.topk(probs, top_k, dim=-1).values[..., -1:]
    routed = torch.where(probs >= kth, probs, torch.zeros((), device=x.device))
    routed = routed / torch.clamp(routed.sum(dim=-1, keepdim=True), min=1e-9)

    cap = capacity(s, top_k, e, capacity_factor)
    gate_vals, token_idx = expert_choice(routed, cap)
    xin = gather_tokens(x, token_idx)
    h = F.silu(torch.bmm(xin, p["w_gate"].to(x.dtype))) * torch.bmm(xin, p["w_up"].to(x.dtype))
    xo = torch.bmm(h, p["w_down"].to(x.dtype))
    xo = xo * gate_vals.transpose(0, 1).reshape(e, -1, 1).to(x.dtype)
    out = combine(x, xo, token_idx)

    # (on DTensors, the means over the sharded batch resolved at once)
    me = resolve_partial(probs.mean(dim=(0, 1)))
    ce = resolve_partial((routed > 0).float().mean(dim=(0, 1))) * e / top_k
    load_balance = e * torch.sum(me * ce)
    z_loss = resolve_partial(torch.mean(torch.square(torch.logsumexp(logits, dim=-1))))
    return out, {"load_balance": load_balance, "router_z": z_loss}


def gather_tokens(x: torch.Tensor, token_idx: torch.Tensor) -> torch.Tensor:
    """x (B, S, d), token_idx (B, E, C) -> each expert's tokens in
    expert-major rows (E, B·C, d), batch-major within an expert, so that
    each expert is one GEMM whatever B."""
    b, e, cap = token_idx.shape
    d = x.shape[-1]
    xin = torch.gather(x, 1, token_idx.reshape(b, e * cap, 1).expand(b, e * cap, d))
    return xin.reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)


def combine(x: torch.Tensor, xo: torch.Tensor, token_idx: torch.Tensor) -> torch.Tensor:
    """The experts' weighted outputs xo (E, B·C, d) added back at their
    tokens: (B, S, d) in x's dtype, one ``scatter_add_`` an expert in
    expert order.  On DTensors xo is first redistributed once to hold
    every expert on each rank (its pending sums over "model" reduced,
    its expert shards gathered, its batch shard kept), and each expert's
    add then runs on the rank's batch rows."""
    b, e, cap = token_idx.shape
    d = x.shape[-1]
    if isinstance(xo, DTensor):
        keep = [p if isinstance(p, Shard) and p.dim == 1 else Replicate() for p in xo.placements]
        xo = xo.redistribute(xo.device_mesh, keep)
    xo = xo.reshape(e, b, cap, d)
    out = torch.zeros_like(x)
    for j in range(e):
        out.scatter_add_(1, token_idx[:, j, :, None].expand(b, cap, d), xo[j])
    return out
