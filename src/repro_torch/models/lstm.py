"""Single-layer LSTM glucose predictor (the paper's model, §3.2; the
counterpart of ``repro.models.lstm``).

A univariate CGM history (B, L) runs through one LSTM layer and the last
hidden state is projected to the glucose level ahead.  The parameter
dict is the JAX model's: ``wx (I, 4H)``, ``wh (H, 4H)``, ``b (4H,)``
with the forget-gate bias set to 1, ``w_out (H, 1)``, ``b_out (1,)``,
gates ordered i, f, g, o.  ``apply`` and ``apply_rows`` (evaluation
and serving) and ``apply_groups`` (a sweep's G populations over shared
windows) are one call of ``kernels.ops.lstm_forward``: the CUDA
kernel for CUDA tensors, its plain twin for CPU tensors.
``apply_nodes`` is the trainer's differentiable forward over the
federation, in plain PyTorch ops that autograd follows; the JAX package
also trains through its plain ``jnp`` cell (``use_kernel=False``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.kernels.ops import lstm_forward
from repro_torch.models.base import Model, Params


def lstm_cell(x_t, h, c, wx, wh, b):
    """One LSTM step with a leading node axis on every operand, gates
    ordered (i, f, g, o) as in ``repro.models.lstm.lstm_cell_ref``:
    x_t (N, B, I), h/c (N, B, H), wx (N, I, 4H), wh (N, H, 4H),
    b (N, 1, 4H)."""
    z = torch.bmm(x_t, wx) + torch.bmm(h, wh) + b
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def _as_steps(x: torch.Tensor) -> torch.Tensor:
    """(..., L) univariate or (..., L, I) history -> (..., L, I)."""
    return x[..., None] if x.dim() == 2 else x


@dataclass(frozen=True)
class LSTMModel:
    history_len: int = 12
    hidden: int = 128
    input_size: int = 1

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Draw fresh params from ``generator`` (on its device), then
        move them to ``device`` (default: the generator's device).
        Same scales as the JAX model; not the same numbers."""
        hsz, isz = self.hidden, self.input_size

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=generator.device)

        b = torch.zeros(4 * hsz, device=generator.device)
        b[hsz : 2 * hsz] = 1.0  # forget-gate bias 1.0 (standard LSTM init)
        params = {
            "wx": normal(isz, 4 * hsz) * (1.0 / math.sqrt(isz)),
            "wh": normal(hsz, 4 * hsz) * (1.0 / math.sqrt(hsz)),
            "b": b,
            "w_out": normal(hsz, 1) * (1.0 / math.sqrt(hsz)),
            "b_out": torch.zeros(1, device=generator.device),
        }
        if device is not None:
            params = {k: v.to(device) for k, v in params.items()}
        return params

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (B, L) normalized glucose -> (B,) prediction, one weight
        set for every row (one launch, G=1, R=B)."""
        stacked = {k: v[None] for k, v in params.items()}
        return self._forward(stacked, _as_steps(x)[None])[0]

    def apply_rows(self, stacked: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (G, L) -> (G,), row g under its own weights ``stacked[k][g]``
        (one launch, R=1).  A row's result does not depend on G."""
        return self._forward(stacked, _as_steps(x)[:, None])[:, 0]

    def apply_groups(self, stacked: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (R, L) -> (G, R), every row under each group's weights
        ``stacked[k][g]``: a sweep's G population models over one set of
        windows, in one launch with G groups.  Group g's row equals
        ``apply`` under its weights alone, bitwise on the CPU."""
        xs = _as_steps(x)
        g = stacked["wx"].shape[0]
        return self._forward({k: v.contiguous() for k, v in stacked.items()},
                             xs[None].expand(g, *xs.shape))

    def apply_nodes(self, stacked: Params, x: torch.Tensor) -> torch.Tensor:
        """x: (N, Bt, L) -> (N, Bt), node n's batch under its own
        weights ``stacked[k][n]``.  Plain batched matmuls (``torch.bmm``
        per step), so autograd gives each node its own gradient; the
        kernels are never on this path."""
        xs = x if x.dim() == 4 else x[..., None]
        n, bt, steps, _ = xs.shape
        h = xs.new_zeros((n, bt, self.hidden))
        c = xs.new_zeros((n, bt, self.hidden))
        b = stacked["b"][:, None, :]
        for t in range(steps):
            h, c = lstm_cell(xs[:, :, t, :], h, c, stacked["wx"], stacked["wh"], b)
        return (torch.bmm(h, stacked["w_out"]) + stacked["b_out"][:, None, :])[..., 0]

    @staticmethod
    def _forward(stacked: Params, xs: torch.Tensor) -> torch.Tensor:
        return lstm_forward(
            xs.contiguous(), stacked["wx"], stacked["wh"], stacked["b"],
            stacked["w_out"], stacked["b_out"],
        )

    def as_model(self) -> Model:
        return Model("lstm", self.init, self.apply, self.apply_nodes,
                     apply_rows=self.apply_rows, apply_groups=self.apply_groups)
