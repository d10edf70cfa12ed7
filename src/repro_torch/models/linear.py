"""Linear-regression baseline, the paper's LR (the counterpart of
``repro.models.linear``).

Trainable by SGD like every other model (``apply_nodes`` is one batched
matmul over the node axis), plus :func:`fit_closed_form`, the ridge
solve the Table-4 benchmark uses for speed.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.base import Model, Params


@dataclass(frozen=True)
class LinearModel:
    history_len: int = 12
    hidden: int = 0  # unused; uniform ctor signature

    def init(self, generator: torch.Generator | None = None, device=None) -> Params:
        """Zeros, as the JAX model (``generator`` is unused)."""
        return {"b": torch.zeros((), device=device),
                "w": torch.zeros(self.history_len, device=device)}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x (B, L) -> (B,): ``x @ w + b``, as row 0 of
        :meth:`apply_nodes`."""
        return self.apply_nodes({k: v[None] for k, v in params.items()}, x[None])[0]

    def apply_nodes(self, stacked: Params, x: torch.Tensor) -> torch.Tensor:
        """x (N, Bt, L) -> (N, Bt), node n's batch under its own
        ``w`` (N, L) and ``b`` (N,)."""
        return torch.baddbmm(stacked["b"][:, None, None], x, stacked["w"][:, :, None])[..., 0]

    def as_model(self) -> Model:
        return Model("lr", self.init, self.apply, self.apply_nodes)


def fit_closed_form(x: torch.Tensor, y: torch.Tensor, l2: float = 1e-3) -> Params:
    """Ridge regression in float32 on ``x``'s device: the
    :class:`LinearModel` params solving ``(Xb^T Xb + l2 I) c = Xb^T y``
    with ``Xb = [x, 1]``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    n, d = x.shape
    xb = torch.cat([x, torch.ones((n, 1), dtype=x.dtype, device=x.device)], dim=1)
    gram = xb.T @ xb + l2 * torch.eye(d + 1, dtype=x.dtype, device=x.device)
    coef = torch.linalg.solve(gram, xb.T @ y)
    return {"b": coef[d], "w": coef[:d]}
