"""Cold-start personalization, paper Fig 3 (the counterpart of
``repro.core.personalize``): fine-tune the population model on one
patient's own CGM history, the path a newly diagnosed patient takes
before the population model has seen them.

Every engine runs the same fine-tune: ``steps`` optimizer steps from a
fresh ``optimizer.init``, each on a minibatch of the patient's windows
with the loss ``mean((apply(p, bx) - by)^2)``.  The minibatch indices
are an input, ``batch_idx``: (steps, bs) for one patient, (P, steps, bs)
for a cohort, drawn by ``utils.rng.draw_personalize`` (with replacement
from the patient's ``count`` real rows, ``bs`` the batch size clamped
to the padded history length M) or, in the parity tests, by
``jax.random`` in the JAX package's order.

  * :func:`personalize_batch` / :func:`personalize_batch_fn` run P
    patients as the trainer's local step runs N nodes: the cohort's
    params are one flat (P, D) buffer (``utils.pytree.ParamLayout``),
    each step one loss and gradient of every patient's rows
    (``core.gluadfl.mse_value_and_grad``: for the LSTM its hand-written
    ``forward_for_grad``), then ``optimizer.update`` on the rows.  Row i is patient i's own
    fine-tune: the rows share no parameters.
  * :func:`personalize` is that body for one patient, with no host
    sync between steps (the JAX package's ``lax.scan`` engine).
  * :func:`personalize_loop` is the reference twin: it reads each
    step's indices on the host (one sync a step) and indexes the
    history with them, and is bitwise :func:`personalize`.

The JAX package fine-tunes through the plain ``jnp`` cell under
``jax.grad`` (its Pallas cell has no backward); the port through the
trainer's hand-written gradient, whose gate kernels
(``lstm_gates_fwd`` / ``lstm_gates_bwd``) run on the card.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.gluadfl import mse_value_and_grad
from repro_torch.models.base import Model, Params
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import ParamLayout
from repro_torch.utils.rng import clamped_batch


def _inputs(population_params: Params, batch_idx, x, y):
    """The population's flat (1, D) row and layout, and the draws and
    history as tensors on the population's device."""
    layout = ParamLayout.of(population_params)
    p0 = layout.flatten({k: v[None] for k, v in population_params.items()})
    dev = p0.device
    return (layout, p0, torch.as_tensor(batch_idx, dtype=torch.int64, device=dev),
            torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, dtype=torch.float32, device=dev))


def _fine_tune(model: Model, optimizer: Optimizer, layout: ParamLayout, p0: torch.Tensor,
               batch_idx: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """The body every batched engine shares: P patients' fine-tunes from
    the population row ``p0`` (1, D) on ``x`` (P, M, L), ``y`` (P, M)
    with ``batch_idx`` (P, steps, bs).  Returns the (P, D) params and
    the (P, steps) losses, all on the device."""
    n_pat, steps, _ = batch_idx.shape
    params = p0.repeat(n_pat, 1)
    state = optimizer.init(params)
    seq = x.shape[2]
    losses = []
    for s in range(steps):
        idx = batch_idx[:, s]
        bx = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, seq))
        by = torch.gather(y, 1, idx)
        loss, grads = mse_value_and_grad(model, layout, params, bx, by)
        params, state = optimizer.update(grads, state, params)
        losses.append(loss)
    return params, (torch.stack(losses, dim=1) if losses else params.new_zeros((n_pat, 0)))


def personalize(model: Model, optimizer: Optimizer, population_params: Params,
                batch_idx, x, y) -> Params:
    """Fine-tune the population params on one patient: ``x`` (M, L),
    ``y`` (M,), ``batch_idx`` (steps, bs) (the patient's row of
    ``utils.rng.draw_personalize``).  Every step stays on the device;
    returns the personalized params (views into one new (D,) row)."""
    layout, p0, idx, xs, ys = _inputs(population_params, batch_idx, x, y)
    params, _ = _fine_tune(model, optimizer, layout, p0, idx[None], xs[None], ys[None])
    return layout.row(params[0])


def personalize_batch(model: Model, optimizer: Optimizer, population_params: Params,
                      batch_idx, x, y) -> Params:
    """Fine-tune P patients from the same population params as one
    batched computation: ``x`` (P, M, L), ``y`` (P, M), ``batch_idx``
    (P, steps, bs).  Returns the stacked params (leaves (P, ...)); row
    i is :func:`personalize` of patient i under ``batch_idx[i]``."""
    layout, p0, idx, xs, ys = _inputs(population_params, batch_idx, x, y)
    params, _ = _fine_tune(model, optimizer, layout, p0, idx, xs, ys)
    return layout.views(params)


def personalize_batch_fn(model: Model, optimizer: Optimizer, *, steps: int = 100,
                         batch_size: int = 32, n_rows: int) -> Callable:
    """The batched fine-tune as a reusable closure for serving, built for
    one padded history length ``n_rows`` (M):
    ``f(population_params, batch_idx, x, y) -> (stacked params,
    (P, steps) losses)``, refusing draws of another shape than
    (P, steps, ``clamped_batch(batch_size, n_rows)``)."""
    bs = clamped_batch(batch_size, n_rows)

    def fine_tune(population_params: Params, batch_idx, x, y):
        layout, p0, idx, xs, ys = _inputs(population_params, batch_idx, x, y)
        if xs.shape[1] != n_rows or idx.shape[1:] != (steps, bs):
            raise ValueError(f"built for M={n_rows}, draws (P, {steps}, {bs}); got x "
                             f"{tuple(xs.shape)} and batch_idx {tuple(idx.shape)}")
        params, losses = _fine_tune(model, optimizer, layout, p0, idx, xs, ys)
        return layout.views(params), losses

    return fine_tune


def personalize_loop(model: Model, optimizer: Optimizer, population_params: Params,
                     batch_idx, x, y) -> Params:
    """The reference twin of :func:`personalize`: each step's indices are
    read on the host and index the history directly (a host sync a
    step); the same arithmetic, so bitwise :func:`personalize`."""
    layout, params, idx, xs, ys = _inputs(population_params, batch_idx, x, y)
    state = optimizer.init(params)
    for s in range(idx.shape[0]):
        rows = idx[s].tolist()
        _, grads = mse_value_and_grad(model, layout, params, xs[rows][None], ys[rows][None])
        params, state = optimizer.update(grads, state, params)
    return layout.row(params[0])
