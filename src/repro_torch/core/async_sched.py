"""Wait-free participation schedules (paper §3.3, Fig 5; the
counterpart of ``repro.core.async_sched``).

The round's activity is drawn as one ``(N,)`` uniform vector ``u``
(``RoundDraws.u_act``); both schedules read it, so the parity tests
hand in the uniforms ``jax.random.uniform(k_act, (N,))`` gives and get
the JAX package's masks bitwise.  Inactive nodes neither communicate
nor train that round.
"""
from __future__ import annotations

import torch


def bernoulli_active(u: torch.Tensor, inactive_ratio: float) -> torch.Tensor:
    """iid active mask, P(active) = 1 - inactive_ratio; at least one node
    is active (the one with the largest ``u``, the first on ties)."""
    if inactive_ratio <= 0.0:
        return torch.ones_like(u)
    active = (u >= inactive_ratio).to(torch.float32)
    fallback = torch.zeros_like(active)
    fallback[torch.argmax(u)] = 1.0
    return torch.where(active.max() > 0, active, fallback)


def markov_active(
    u: torch.Tensor, prev_active: torch.Tensor, p_stay_active: float = 0.9,
    p_stay_inactive: float = 0.7,
) -> torch.Tensor:
    """Sticky busy/free chain: a node active (inactive) last round stays
    active with ``p_stay_active`` (activates with
    ``1 - p_stay_inactive``).  At least one node is active: the one
    closest to its activation threshold."""
    stay = torch.where(prev_active > 0, torch.tensor(p_stay_active, dtype=torch.float32),
                       torch.tensor(1.0 - p_stay_inactive, dtype=torch.float32)).to(u.device)
    active = (u < stay).to(torch.float32)
    fallback = torch.zeros_like(active)
    fallback[torch.argmin(u - stay)] = 1.0
    return torch.where(active.max() > 0, active, fallback)


def staleness_update(staleness: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Rounds since each node last participated (0 when active)."""
    return (staleness + 1) * (1 - active)
