"""Meta-learning baselines: MAML and MetaSGD (paper §4.4; the
counterpart of ``repro.core.meta``).

Tasks are patients.  MAML (Finn et al.) learns an initialization that
adapts in a few inner SGD steps; MetaSGD (Li et al.) also learns a
per-parameter inner learning rate.  The paper evaluates both WITHOUT
test-time fine-tuning (the population-model setting), so ``train``
returns the meta-initialization itself.

A meta-step is second-order MAML, as JAX's ``jax.grad`` inside
``value_and_grad`` is: the N tasks are the rows of an ``(N, D)`` buffer
``theta.expand(N, -1)``; each inner step takes
``torch.autograd.grad(..., create_graph=True)`` of the summed task
losses WITH RESPECT TO THE ROWS (each row its own task's gradient; with
respect to theta every task would get the sum) and steps
``rows - lrs * g``; the meta-loss is the mean of the adapted rows' query
losses, differentiated back to theta (and to ``lrs`` for MetaSGD).
MetaSGD's meta-optimizer acts on the packed row ``[lrs, params]``, the
sorted-key order of JAX's ``{"lrs", "params"}``.

Randomness is an input: a meta-step's support and query batch indices
are a :class:`~repro_torch.utils.rng.MetaDraws`, drawn by
``utils.rng.draw_meta`` or handed in (the parity tests draw them with
``jax.random`` in ``MAML.train``'s split order).  Engines as in
``core.fedavg``: ``"scan"`` syncs once per chunk through
``chunked.dispatch_chunk``, ``"loop"`` is that engine at one step a
chunk, without early stop.
Spans: ``meta.draws``, ``meta.inner``, ``meta.outer``, ``meta.eval``.
A custom ``loss_fn`` is not ported (it raises).
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch

from repro_torch.core import chunked
from repro_torch.core.chunked import (
    LOSS_FN_REFUSAL,
    draw_stream,
    engine_chunk,
    initial_row,
    val_mse,
    val_tensors,
)
from repro_torch.core.gluadfl import FedTensors
from repro_torch.device import resolve_device
from repro_torch.models.base import Model, Params
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import ParamLayout
from repro_torch.utils.rng import MetaDraws, draw_meta
from repro_torch.utils.tracing import span


class MAML:
    """MAML over the patients of a federation.  ``device`` defaults to
    CUDA and raises without a GPU; pass ``"cpu"`` for the CPU."""

    learn_inner_lr = False

    def __init__(
        self,
        model: Model,
        meta_optimizer: Optimizer,
        *,
        inner_lr: float = 1e-2,
        inner_steps: int = 3,
        loss_fn: Callable | None = None,
        device=None,
    ):
        if loss_fn is not None:
            raise NotImplementedError(LOSS_FN_REFUSAL)
        self.device = resolve_device(device)
        self.model = model
        self.meta_opt = meta_optimizer
        self.inner_lr = inner_lr
        self.inner_steps = inner_steps
        self.layout = ParamLayout.of(model.init(torch.Generator().manual_seed(0)))

    def _task_losses(self, rows: torch.Tensor, data: FedTensors, idx: torch.Tensor):
        """Each task's MSE (N,) on its windows ``idx`` (N, B) under its
        own row of ``rows`` (N, D), differentiable in ``rows``."""
        bx, by = data.batches(idx)
        pred = self.model.apply_nodes(self.layout.views(rows), bx)
        return torch.mean(torch.square(pred - by), dim=1)

    def meta_step(self, params: torch.Tensor, lrs: torch.Tensor, meta_state: dict,
                  data: FedTensors, draws: MetaDraws):
        """One meta-step over every task from the meta-params ``params``
        and inner rates ``lrs`` (both (D,)): returns ``(params, lrs,
        meta_state, loss)``, the loss the mean query loss, 0-d on the
        device (no host sync)."""
        dev = params.device
        support, query = draws.support.to(dev), draws.query.to(dev)
        n = data.x.shape[0]
        theta = params.detach().requires_grad_(True)
        rate = lrs.detach().requires_grad_(self.learn_inner_lr)
        with torch.enable_grad(), span("meta.inner"):
            rows = theta.expand(n, -1)
            for s in range(self.inner_steps):
                losses = self._task_losses(rows, data, support[:, s])
                (grads,) = torch.autograd.grad(losses.sum(), rows, create_graph=True)
                rows = rows - rate * grads
        # one span for the query, the meta-gradient and the update, so the
        # backward's kernels (launched by autograd's device thread) fall
        # inside its range on the device timeline
        with span("meta.outer"):
            with torch.enable_grad():
                loss = self._task_losses(rows, data, query).mean()
                wrt = (rate, theta) if self.learn_inner_lr else (theta,)
                meta_grads = torch.autograd.grad(loss, wrt)
            if self.learn_inner_lr:
                packed, grads = torch.cat([lrs, params])[None], torch.cat(meta_grads)[None]
                new, meta_state = self.meta_opt.update(grads, meta_state, packed)
                d = params.shape[0]
                return new[0, d:], new[0, :d], meta_state, loss.detach()
            new, meta_state = self.meta_opt.update(meta_grads[0][None], meta_state, params[None])
            return new[0], lrs, meta_state, loss.detach()

    def val_loss(self, params: torch.Tensor, val_x: torch.Tensor, val_y: torch.Tensor):
        with span("meta.eval"):
            return val_mse(self.model, self.layout, params, val_x, val_y)

    def train(self, generator: torch.Generator | None, x, y, counts, *, batch_size: int = 64,
              steps: int = 100, engine: str = "scan", chunk: int | None = None, val_data=None,
              eval_every: int = 0, early_stop_patience: int = 0, params: Params | None = None,
              draws: Iterable[MetaDraws] | None = None):
        """Meta-train; returns ``(params, lrs, history)``, the
        meta-initialization and the inner rates as param dicts.

        ``generator`` (on the trainer's device) draws the initial params
        unless ``params`` is given, and each step's draws unless
        ``draws`` yields them.  Engines, eval and early stopping as in
        :meth:`repro_torch.core.fedavg.FedAvg.train`."""
        chunk, patience = engine_chunk(engine, chunk, early_stop_patience)
        dev = self.device
        data = FedTensors.of(x, y, counts, dev)
        val_x, val_y = val_tensors(val_data, dev)
        do_eval = bool(eval_every) and val_data is not None
        if early_stop_patience and not do_eval:
            raise ValueError("early_stop_patience requires val_data and eval_every")
        next_draws = draw_stream(draws, lambda: draw_meta(
            generator, data.counts, inner_steps=self.inner_steps, batch_size=batch_size),
            "meta.draws")
        row = initial_row(self.model, self.layout, generator, params, dev)
        lrs = torch.full_like(row, self.inner_lr)
        meta_state = self.meta_opt.init(
            torch.cat([lrs, row])[None] if self.learn_inner_lr else row[None])
        history: list[dict] = []
        ee = eval_every if do_eval else 0

        def body(c, t):
            *c, loss = self.meta_step(*c, data, next_draws())
            val = chunked.boundary_val(lambda q: self.val_loss(q, val_x, val_y), c[0], t, ee, dev)
            return tuple(c), (loss, val)

        def chunk_fn(c, stop, t0, size):
            return chunked.scan_rounds(body, c, range(t0, t0 + size), stop,
                                       patience=patience)

        carry = chunked.run_chunks(chunk_fn, (row, lrs, meta_state), total=steps, chunk=chunk,
                                   device=dev, eval_every=ee, patience=patience,
                                   history=history)
        row, lrs, _ = carry
        return self.layout.row(row), self.layout.row(lrs), history


class MetaSGD(MAML):
    """MAML + learnable per-parameter inner learning rates."""

    learn_inner_lr = True
