"""N-BEATS (Oreshkin et al., ICLR'20) for single-point BGLP (the
counterpart of ``repro.models.nbeats``).

Generic-basis N-BEATS: a stack of fully-connected blocks; each block
emits a *backcast* (subtracted from the residual input) and a
*forecast* (accumulated), with a 1-point forecast head.  The params are
the JAX model's tree flattened to dotted keys
(``blocks.0.layers.1.w``; ``models.base.flatten_tree``), so their
sorted order is ``jax.tree.leaves`` order.  ``apply_nodes`` runs a
leading node axis through every dense layer (``baddbmm``, then ReLU);
``apply`` is its row 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.base import Model, Params, leaf_key


def _dense_init(generator: torch.Generator, n_in: int, n_out: int) -> dict[str, torch.Tensor]:
    """``w`` uniform on ``[-1/sqrt(n_in), 1/sqrt(n_in))`` (the JAX
    model's scale; not its numbers), ``b`` zeros, on the generator's
    device."""
    lim = 1.0 / math.sqrt(n_in)
    w = torch.rand((n_in, n_out), generator=generator, device=generator.device)
    return {"b": torch.zeros(n_out, device=generator.device), "w": (2 * w - 1) * lim}


def _dense(stacked: Params, key: str, x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` with a leading node axis: x (N, B, in) under the
    layer ``key``'s ``w`` (N, in, out) and ``b`` (N, out)."""
    return torch.baddbmm(stacked[key + ".b"][:, None, :], x, stacked[key + ".w"])


def _init_layers(generator: torch.Generator, prefix: tuple, n_in: int, hidden: int,
                 num_layers: int, n_back: int) -> Params:
    """One block's or stack's FC layers and its backcast and forecast
    heads, under dotted keys starting ``prefix``."""
    sizes = [(n_in, hidden)] + [(hidden, hidden)] * (num_layers - 1)
    heads = {"backcast": (hidden, n_back), "forecast": (hidden, 1)}
    out = {}
    for i, (a, b) in enumerate(sizes):
        for k, v in _dense_init(generator, a, b).items():
            out[leaf_key(*prefix, "layers", (i, num_layers), k)] = v
    for name, (a, b) in heads.items():
        for k, v in _dense_init(generator, a, b).items():
            out[leaf_key(*prefix, name, k)] = v
    return out


def _hidden(stacked: Params, prefix: tuple, num_layers: int, h: torch.Tensor) -> torch.Tensor:
    """The block's FC layers, each followed by ReLU."""
    for i in range(num_layers):
        h = torch.relu(_dense(stacked, leaf_key(*prefix, "layers", (i, num_layers)), h))
    return h


@dataclass(frozen=True)
class NBeatsModel:
    history_len: int = 12
    hidden: int = 128
    num_blocks: int = 3
    num_layers: int = 3  # FC layers per block

    def _prefix(self, b: int) -> tuple:
        return ("blocks", (b, self.num_blocks))

    def init(self, generator: torch.Generator, device=None) -> Params:
        params = {}
        for b in range(self.num_blocks):
            params.update(_init_layers(generator, self._prefix(b), self.history_len,
                                       self.hidden, self.num_layers, self.history_len))
        return params if device is None else {k: v.to(device) for k, v in params.items()}

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x (B, L) -> (B,) forecast."""
        return self.apply_nodes({k: v[None] for k, v in params.items()}, x[None])[0]

    def apply_nodes(self, stacked: Params, x: torch.Tensor) -> torch.Tensor:
        """x (N, Bt, L) -> (N, Bt), node n's batch under its own
        weights ``stacked[k][n]``."""
        residual = x
        forecast = x.new_zeros((*x.shape[:2], 1))
        for b in range(self.num_blocks):
            prefix = self._prefix(b)
            h = _hidden(stacked, prefix, self.num_layers, residual)
            residual = residual - _dense(stacked, leaf_key(*prefix, "backcast"), h)
            forecast = forecast + _dense(stacked, leaf_key(*prefix, "forecast"), h)
        return forecast[..., 0]

    def as_model(self) -> Model:
        return Model("nbeats", self.init, self.apply, self.apply_nodes)
