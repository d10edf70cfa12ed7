"""FedAvg baseline (McMahan et al., AISTATS'17), the paper's centralized
FL comparison (star topology, Figure 1b; the counterpart of
``repro.core.fedavg``).

Round: the server broadcasts w; each participating client runs its
local steps on its own data from a fresh ``optimizer.init``; the server
averages the client models weighted by their sample counts.  The N
clients are one flat ``(N, D)`` buffer (``utils.pytree.ParamLayout``),
as in ``GluADFL``, and each local step is one
``core.gluadfl.mse_value_and_grad`` over all of them through
``Model.apply_nodes``.

The two rules the JAX package pins (``tests/test_baselines.py``):

  * **Inactive clients are inert.**  Each local step is where-gated on
    the client's activity -- params, optimizer rows and loss -- so an
    inactive client's rows pass through bitwise and its loss is a clean
    zero; nothing it computes (NaN from a poisoned shard included)
    reaches the aggregate, which is ``sum(w * cp) + (1 - sum(w)) * old``
    with ``w = active * counts / max(sum(active * counts), 1)``.
  * **Epochs are not steps.**  ``local_epochs=k`` resolves to
    ``ceil(max(counts) / batch_size) * k`` local steps
    (:meth:`FedAvg.resolve_local_steps`); ``None`` keeps
    ``cfg.local_steps``.

Randomness is an input: a round's draws are a
:class:`~repro_torch.utils.rng.RoundDraws` (activity uniforms and the
clients' batch indices, no scores), drawn by ``utils.rng.draw_round``
from a ``torch.Generator`` or handed in (the parity tests draw them
with ``jax.random`` in ``FedAvg.train``'s split order).

Engines: ``train(engine="scan")`` (default) runs chunks of rounds
through ``chunked.dispatch_chunk`` with one host sync per chunk, with
optional streaming eval (``val_data`` + ``eval_every``, NaN-sentinel
off-boundary) and early stopping (``early_stop_patience``);
``engine="loop"`` is the same engine at one round a chunk, so it syncs
every round with the same numbers; like the JAX package's loop it
ignores ``early_stop_patience`` and trains every round.  Spans:
``fedavg.draws``, ``fedavg.local_step``, ``fedavg.aggregate``,
``fedavg.eval``.  A custom ``loss_fn`` is not ported (it raises).
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core import chunked
from repro_torch.core.async_sched import bernoulli_active
from repro_torch.core.chunked import (
    LOSS_FN_REFUSAL,
    draw_stream,
    engine_chunk,
    initial_row,
    val_mse,
    val_tensors,
)
from repro_torch.core.gluadfl import FedTensors, mse_value_and_grad
from repro_torch.device import resolve_device
from repro_torch.models.base import Model, Params
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import ParamLayout
from repro_torch.utils.rng import RoundDraws, draw_round
from repro_torch.utils.tracing import span


class FedAvg:
    """FedAvg over ``cfg.num_nodes`` clients.  ``device`` defaults to
    CUDA and raises without a GPU; pass ``"cpu"`` for the CPU."""

    def __init__(
        self,
        model: Model,
        optimizer: Optimizer,
        cfg: FLConfig,
        *,
        local_epochs: int | None = None,
        loss_fn: Callable | None = None,
        device=None,
    ):
        if loss_fn is not None:
            raise NotImplementedError(LOSS_FN_REFUSAL)
        if local_epochs is not None and local_epochs < 1:
            raise ValueError(f"local_epochs must be >= 1, got {local_epochs}")
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.local_epochs = local_epochs
        self.layout = ParamLayout.of(model.init(torch.Generator().manual_seed(0)))

    def resolve_local_steps(self, counts, batch_size: int) -> int:
        """The per-round local step count: ``cfg.local_steps`` verbatim,
        or -- with ``local_epochs`` set -- ``ceil(max(counts)/batch_size)
        * local_epochs`` (one "epoch" = enough uniform batches to cover
        the largest client's data once; every client takes the same
        number of steps, so the largest client defines it)."""
        if self.local_epochs is None:
            return max(1, int(self.cfg.local_steps))
        biggest = max(1, int(max(counts)))
        return math.ceil(biggest / batch_size) * self.local_epochs

    def client_update(self, params: torch.Tensor, data: FedTensors, active: torch.Tensor,
                      batch_idx: torch.Tensor):
        """Every client's local steps from the broadcast row ``params``
        (D,) and a fresh ``optimizer.init``, on its windows ``batch_idx``
        (N, local_steps, B): returns the client rows (N, D) and each
        client's mean local loss (N,).  Inactive clients (``active`` 0)
        keep ``params`` and report 0, whatever their data hold."""
        n = self.cfg.num_nodes
        keep = active > 0
        with span("fedavg.local_step"):
            p = params[None].repeat(n, 1)
            state = self.optimizer.init(p)
            losses = []
            for s in range(batch_idx.shape[1]):
                bx, by = data.batches(batch_idx[:, s])
                loss, grads = mse_value_and_grad(self.model, self.layout, p, bx, by)
                new_p, new_state = self.optimizer.update(grads, state, p)
                # where-gated: an inactive row passes through bitwise
                p = torch.where(keep[:, None], new_p, p)
                state = {k: None if v is None else
                         torch.where(keep.reshape(n, *(1,) * (v.dim() - 1)), v, state[k])
                         for k, v in new_state.items()}
                losses.append(torch.where(keep, loss, 0.0))
            return p, torch.stack(losses).mean(dim=0)

    def round(self, params: torch.Tensor, data: FedTensors, draws: RoundDraws):
        """One round from the population row ``params`` (D,): returns
        ``(new_params (D,), loss)``, the loss the active clients' mean
        of their mean local loss, 0-d on the device (no host sync)."""
        dev = params.device
        active = bernoulli_active(draws.u_act.to(dev), self.cfg.inactive_ratio)
        keep = active > 0
        client_params, client_loss = self.client_update(params, data, active,
                                                        draws.batch_idx.to(dev))
        with span("fedavg.aggregate"):
            w = active * data.counts.to(torch.float32)
            w = w / torch.clamp_min(torch.sum(w), 1.0)
            new_params = (torch.sum(w[:, None] * client_params, dim=0)
                          + (1.0 - torch.sum(w)) * params)
            loss = (torch.sum(torch.where(keep, client_loss, 0.0))
                    / torch.clamp_min(torch.sum(active), 1.0))
        return new_params, loss

    def val_loss(self, params: torch.Tensor, val_x: torch.Tensor, val_y: torch.Tensor):
        with span("fedavg.eval"):
            return val_mse(self.model, self.layout, params, val_x, val_y)

    def train(self, generator: torch.Generator | None, x, y, counts, *, batch_size: int = 64,
              rounds: int | None = None, engine: str = "scan", chunk: int | None = None,
              val_data=None, eval_every: int = 0, early_stop_patience: int = 0,
              params: Params | None = None, draws: Iterable[RoundDraws] | None = None):
        """Train the federation; returns ``(params, history)``.

        ``generator`` (on the trainer's device) draws the initial params
        unless ``params`` is given, and each round's draws unless
        ``draws`` yields them.  ``engine="scan"`` (default) syncs once
        per ``chunk`` rounds; ``engine="loop"`` every round, with the
        same numbers.  ``val_data=(vx, vy)`` + ``eval_every=k`` records
        ``val_loss`` every k rounds; ``early_stop_patience=p`` (scan engine)
        stops after p consecutive non-improving evals."""
        chunk, patience = engine_chunk(engine, chunk, early_stop_patience)
        rounds = rounds if rounds is not None else self.cfg.rounds
        local_steps = self.resolve_local_steps(np.asarray(counts), batch_size)
        dev = self.device
        data = FedTensors.of(x, y, counts, dev)
        val_x, val_y = val_tensors(val_data, dev)
        do_eval = bool(eval_every) and val_data is not None
        if early_stop_patience and not do_eval:
            raise ValueError("early_stop_patience requires val_data and eval_every")
        next_draws = draw_stream(draws, lambda: draw_round(
            generator, data.counts, local_steps=local_steps, batch_size=batch_size,
            random_topology=False), "fedavg.draws")
        row = initial_row(self.model, self.layout, generator, params, dev)
        history: list[dict] = []
        ee = eval_every if do_eval else 0

        def body(p, t):
            p, loss = self.round(p, data, next_draws())
            val = chunked.boundary_val(lambda q: self.val_loss(q, val_x, val_y), p, t, ee, dev)
            return p, (loss, val)

        def chunk_fn(carry, stop, t0, c):
            return chunked.scan_rounds(body, carry, range(t0, t0 + c), stop,
                                       patience=patience)

        row = chunked.run_chunks(chunk_fn, row, total=rounds, chunk=chunk, device=dev,
                                 eval_every=ee, patience=patience, history=history)
        return self.layout.row(row), history
