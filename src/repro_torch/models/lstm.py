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
``forward_for_grad`` is the trainer's loss over the federation and a
call for its gradient (every trainer's local step, through
``core.gluadfl.mse_value_and_grad``, which times the two as the step's
forward and backward): backpropagation through time written by hand, ``torch.bmm`` for the products and one
``kernels.ops.lstm_gates_fwd`` / ``lstm_gates_bwd`` a step for the gates
and the cell update (the CUDA kernels on the card, their plain twins on
the CPU), every weight gradient of ``wh`` in one product over the
steps.  ``apply_nodes`` is the same forward in plain differentiable
ops, which the meta-learners' second-order gradients
(``core.meta``) follow with autograd; the JAX package trains through
its plain ``jnp`` cell (``use_kernel=False``) under ``jax.grad``.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import torch

from repro_torch.kernels.ops import lstm_forward, lstm_gates_bwd, lstm_gates_fwd
from repro_torch.models.base import Model, Params
from repro_torch.utils.pytree import ParamLayout


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
        per step), so autograd gives each node its own gradient (the
        meta-learners' path; the other trainers take
        :meth:`forward_for_grad`); no kernel is on this path."""
        xs = x if x.dim() == 4 else x[..., None]
        n, bt, steps, _ = xs.shape
        h = xs.new_zeros((n, bt, self.hidden))
        c = xs.new_zeros((n, bt, self.hidden))
        b = stacked["b"][:, None, :]
        for t in range(steps):
            h, c = lstm_cell(xs[:, :, t, :], h, c, stacked["wx"], stacked["wh"], b)
        return (torch.bmm(h, stacked["w_out"]) + stacked["b_out"][:, None, :])[..., 0]

    def forward_for_grad(self, layout: ParamLayout, params: torch.Tensor, bx: torch.Tensor,
                         by: torch.Tensor) -> tuple[torch.Tensor, Callable[[], torch.Tensor]]:
        """Per-row MSE losses (N,) of ``apply_nodes`` against ``by``
        (N, Bt) at the flat ``params`` (N, D), row n's batch ``bx[n]``
        (Bt, L) or (Bt, L, I), and a call that returns their gradients
        (N, D): the maths of autograd through ``apply_nodes``, by hand.

        The forward keeps the activated gates of every step in one
        (N, L, Bt, 4H) buffer and h_t, c_t in (N, L, Bt, H) ones: a step
        is ``torch.bmm(h_{t-1}, wh)`` into its gate slice (none at t = 0)
        and one ``lstm_gates_fwd``, which adds ``x_t wx + b`` and
        activates in place.  The backward runs one ``lstm_gates_bwd`` a
        step, which writes dG_t over the gates and sums db and dwx, and
        one ``torch.bmm`` for dh_{t-1} = dG_t wh^T; after the loop one
        product over all (L-1)·Bt rows, [h_0 .. h_{L-2}]^T [dG_1 ..
        dG_{L-1}], gives dwh.  Every leaf's gradient is written into its
        view of one (N, D) buffer.  At I > 1 one product over all steps
        puts every x_t wx into the gate buffer before the forward, each
        step adds h_{t-1} wh to it, and one product over all steps after
        the backward gives dwx: the gate kernels take one input a step."""
        p = layout.views(params)
        xs = bx if bx.dim() == 4 else bx[..., None]
        n, bsz, steps, isz = xs.shape
        hsz = self.hidden
        one = isz == 1
        with torch.no_grad():
            gates = params.new_empty((n, steps, bsz, 4 * hsz))
            hs = params.new_empty((n, steps, bsz, hsz))
            cs = params.new_empty((n, steps, bsz, hsz))
            if not one:
                xt = xs.transpose(1, 2).reshape(n, steps * bsz, isz)
                torch.bmm(xt, p["wx"], out=gates.view(n, steps * bsz, 4 * hsz))
            for t in range(steps):
                if t and one:
                    torch.bmm(hs[:, t - 1], p["wh"], out=gates[:, t])
                elif t:
                    gates[:, t].baddbmm_(hs[:, t - 1], p["wh"])
                lstm_gates_fwd(gates[:, t], xs[:, :, t] if one else None, p["wx"] if one else None,
                               p["b"], cs[:, t - 1] if t else None, cs[:, t], hs[:, t])
            h = hs[:, -1]
            err = (torch.bmm(h, p["w_out"]) + p["b_out"][:, None, :])[..., 0] - by
            losses = torch.mean(torch.square(err), dim=1)

        @torch.no_grad()
        def backward() -> torch.Tensor:
            grads = torch.empty_like(params)
            g = layout.views(grads)
            dpred = (err * (2.0 / bsz))[..., None]
            torch.bmm(h.transpose(1, 2), dpred, out=g["w_out"])
            torch.sum(dpred[..., 0], dim=1, keepdim=True, out=g["b_out"])
            dh = torch.bmm(dpred, p["w_out"].transpose(1, 2))
            dc = torch.zeros_like(dh)
            for t in reversed(range(steps)):
                lstm_gates_bwd(gates[:, t], cs[:, t - 1] if t else None, cs[:, t], dh, dc,
                               xs[:, :, t] if one else None, g["b"], g["wx"] if one else None,
                               accumulate=t < steps - 1)
                if t:
                    torch.bmm(gates[:, t], p["wh"].transpose(1, 2), out=dh)
            if steps > 1:
                torch.bmm(hs[:, :-1].reshape(n, -1, hsz).transpose(1, 2),
                          gates[:, 1:].reshape(n, -1, 4 * hsz), out=g["wh"])
            else:
                g["wh"].zero_()
            if not one:
                torch.bmm(xt.transpose(1, 2), gates.view(n, steps * bsz, 4 * hsz), out=g["wx"])
            return grads

        return losses, backward

    @staticmethod
    def _forward(stacked: Params, xs: torch.Tensor) -> torch.Tensor:
        return lstm_forward(
            xs.contiguous(), stacked["wx"], stacked["wh"], stacked["b"],
            stacked["w_out"], stacked["b_out"],
        )

    def as_model(self) -> Model:
        return Model("lstm", self.init, self.apply, self.apply_nodes,
                     apply_rows=self.apply_rows, apply_groups=self.apply_groups,
                     forward_for_grad=self.forward_for_grad)
