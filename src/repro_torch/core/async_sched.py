"""Wait-free participation schedules (paper §3.3, Fig 5; the
counterpart of ``repro.core.async_sched``).

The round's activity is drawn as one ``(N,)`` uniform vector ``u``
(``RoundDraws.u_act``); both schedules read it, so the parity tests
hand in the uniforms ``jax.random.uniform(k_act, (N,))`` gives and get
the JAX package's masks bitwise.  Inactive nodes neither communicate
nor train that round.  The sweep engine stacks G scenarios: ``u`` is
then (G, N), the ratio a (G,) tensor, and each row is decided on its
own, as the unstacked call decides it.
"""
from __future__ import annotations

import torch


def _one_hot_rows(index: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Per row of ``like`` (..., N), 1.0 at ``index`` (...,), else 0."""
    return torch.zeros_like(like).scatter_(-1, index[..., None], 1.0)


def bernoulli_active(u: torch.Tensor, inactive_ratio) -> torch.Tensor:
    """iid active mask from (..., N) uniforms, P(active) = 1 -
    ``inactive_ratio`` (a float, or a (G,) tensor for a (G, N) ``u``),
    compared in float32 as the JAX package does; at least one node of a
    row is active (the one with the largest ``u``, the first on ties).
    A float ratio <= 0 activates every node without reading ``u``; a
    tensor ratio of 0 gives the same, since ``u >= 0`` always."""
    if isinstance(inactive_ratio, (int, float)) and inactive_ratio <= 0.0:
        return torch.ones_like(u)
    ratio = torch.as_tensor(inactive_ratio, dtype=torch.float32, device=u.device)
    active = (u >= ratio[..., None]).to(torch.float32)
    fallback = _one_hot_rows(torch.argmax(u, dim=-1), active)
    return torch.where(active.amax(dim=-1, keepdim=True) > 0, active, fallback)


def sweep_active_masks(u: torch.Tensor, inactive_ratios) -> torch.Tensor:
    """(G, N) bernoulli masks from (G, N) uniforms, row g at its own
    ratio ``inactive_ratios[g]``; row g equals
    ``bernoulli_active(u[g], ratio_g)`` bitwise (the JAX package's
    sampler splits a key per scenario; here each scenario's generator
    drew its own row)."""
    return bernoulli_active(u, torch.as_tensor(inactive_ratios, dtype=torch.float32))


def markov_active(
    u: torch.Tensor, prev_active: torch.Tensor, p_stay_active: float = 0.9,
    p_stay_inactive: float = 0.7,
) -> torch.Tensor:
    """Sticky busy/free chain over (..., N) uniforms: a node active
    (inactive) last round stays active with ``p_stay_active``
    (activates with ``1 - p_stay_inactive``).  At least one node of a
    row is active: the one closest to its activation threshold."""
    stay = torch.where(prev_active > 0, torch.tensor(p_stay_active, dtype=torch.float32),
                       torch.tensor(1.0 - p_stay_inactive, dtype=torch.float32)).to(u.device)
    active = (u < stay).to(torch.float32)
    fallback = _one_hot_rows(torch.argmin(u - stay, dim=-1), active)
    return torch.where(active.amax(dim=-1, keepdim=True) > 0, active, fallback)


def staleness_update(staleness: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Rounds since each node last participated (0 when active)."""
    return (staleness + 1) * (1 - active)
