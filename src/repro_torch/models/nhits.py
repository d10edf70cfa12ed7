"""N-HiTS (Challu et al., AAAI'23) for single-point BGLP (the
counterpart of ``repro.models.nhits``).

Hierarchical interpolation + multi-rate input pooling: each stack sees a
max-pooled (coarsened) view of the residual input, emits
low-dimensional backcast coefficients and a forecast, and linearly
interpolates the backcast back to full resolution.  Pool sizes
decrease across stacks (coarse -> fine).  Params are keyed as
``stacks.0.layers.1.w`` (``models.base.flatten_tree``); ``apply_nodes``
carries a leading node axis, ``apply`` is its row 0.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.base import Model, Params, leaf_key
from repro_torch.models.nbeats import _dense, _hidden, _init_layers


def _maxpool1d(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., L) -> (..., ceil(L/k)) max pooling, the last window padded
    with -inf."""
    if k <= 1:
        return x
    pad = (-x.shape[-1]) % k
    xp = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
    return xp.reshape(*x.shape[:-1], -1, k).amax(dim=-1)


def _interp1d(coef: torch.Tensor, out_len: int) -> torch.Tensor:
    """(..., C) -> (..., out_len) linear interpolation of knot values at
    ``linspace(0, C - 1, out_len)`` in float32 (within 1e-6 of
    ``jnp.linspace``: the two may differ in the last bit)."""
    c = coef.shape[-1]
    if c == out_len:
        return coef
    pos = torch.linspace(0.0, c - 1.0, out_len, dtype=torch.float32, device=coef.device)
    lo = torch.clamp(torch.floor(pos).long(), 0, c - 1)
    hi = torch.clamp(lo + 1, 0, c - 1)
    frac = pos - lo.to(torch.float32)
    return coef[..., lo] * (1 - frac) + coef[..., hi] * frac


@dataclass(frozen=True)
class NHiTSModel:
    history_len: int = 12
    hidden: int = 128
    num_layers: int = 2
    pool_sizes: tuple = (4, 2, 1)      # coarse -> fine stacks
    backcast_knots: tuple = (4, 6, 12)  # interpolation knots per stack

    def _prefix(self, s: int) -> tuple:
        return ("stacks", (s, len(self.pool_sizes)))

    def init(self, generator: torch.Generator, device=None) -> Params:
        params = {}
        for s, (pool, knots) in enumerate(zip(self.pool_sizes, self.backcast_knots)):
            in_len = -(-self.history_len // pool)  # ceil
            params.update(_init_layers(generator, self._prefix(s), in_len, self.hidden,
                                       self.num_layers, knots))
        return params if device is None else {k: v.to(device) for k, v in params.items()}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x (B, L) -> (B,) forecast."""
        return self.apply_nodes({k: v[None] for k, v in params.items()}, x[None])[0]

    def apply_nodes(self, stacked: Params, x: torch.Tensor) -> torch.Tensor:
        """x (N, Bt, L) -> (N, Bt), node n's batch under its own
        weights ``stacked[k][n]``."""
        residual = x
        forecast = x.new_zeros((*x.shape[:2], 1))
        for s, pool in enumerate(self.pool_sizes):
            prefix = self._prefix(s)
            h = _hidden(stacked, prefix, self.num_layers, _maxpool1d(residual, pool))
            back = _dense(stacked, leaf_key(*prefix, "backcast"), h)
            residual = residual - _interp1d(back, self.history_len)
            forecast = forecast + _dense(stacked, leaf_key(*prefix, "forecast"), h)
        return forecast[..., 0]

    def as_model(self) -> Model:
        return Model("nhits", self.init, self.apply, self.apply_nodes)
