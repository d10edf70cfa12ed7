"""Traditional supervised learning on MIXED data (paper Table 3 / §4.4;
the counterpart of ``repro.core.supervised``): all patients' training
windows pooled on one "server", the privacy-free upper-bound baseline
the paper compares FL against.

Engines: ``engine="scan"`` (default) runs chunks of steps through
``chunked.dispatch_chunk`` with one host sync per chunk: the best-val
checkpoint is tracked on the device by where-selects, with optional
early stopping (``early_stop_patience``).  ``engine="loop"`` is the same
engine at one step a chunk, so it syncs every step with the same
numbers; like the JAX package's loop it ignores ``early_stop_patience``
and keeps the best-val checkpoint.  The JAX package caches its compiled step, val and chunk
functions per (model, optimizer, loss, batch) in an ``lru_cache``; with
nothing compiled here there is nothing to cache, so there is no
counterpart.

A step's window indices are an input: drawn by
``utils.rng.draw_supervised`` from a ``torch.Generator``, or handed in
(the parity tests draw them with ``jax.random`` in the JAX trainer's
order).  Spans: ``supervised.draws``, ``supervised.step``,
``supervised.eval``.  A custom ``loss_fn`` is not ported (it raises).
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
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
from repro_torch.core.gluadfl import mse_value_and_grad
from repro_torch.device import resolve_device
from repro_torch.models.base import Model, Params
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import ParamLayout
from repro_torch.utils.rng import draw_supervised
from repro_torch.utils.tracing import span


def train_supervised(
    model: Model,
    optimizer: Optimizer,
    generator: torch.Generator | None,
    x,
    y,
    *,
    batch_size: int = 64,
    steps: int = 500,
    loss_fn: Callable | None = None,
    val: tuple | None = None,
    eval_every: int = 50,
    engine: str = "scan",
    chunk: int | None = None,
    early_stop_patience: int = 0,
    params: Params | None = None,
    draws: Iterable[torch.Tensor] | None = None,
    device=None,
):
    """Optimizer steps on the pooled windows ``x`` (R, L), ``y`` (R,);
    returns ``(params, history)``.

    ``generator`` (on ``device``, default CUDA) draws the initial params
    unless ``params`` is given, and each step's (batch,) indices unless
    ``draws`` yields them.  With ``val`` set, the returned params are
    the best-val checkpoint (the final params if no finite val loss was
    seen)."""
    if loss_fn is not None:
        raise NotImplementedError(LOSS_FN_REFUSAL)
    chunk, patience = engine_chunk(engine, chunk, early_stop_patience)
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
    y = torch.as_tensor(np.asarray(y, np.float32)).to(dev)
    val_x, val_y = val_tensors(val, dev)
    do_eval = val is not None and bool(eval_every)
    if early_stop_patience and not do_eval:
        raise ValueError("early_stop_patience requires val and eval_every")
    layout = ParamLayout.of(model.init(torch.Generator().manual_seed(0)))
    next_idx = draw_stream(draws, lambda: draw_supervised(generator, x.shape[0], batch_size),
                           "supervised.draws")
    row = initial_row(model, layout, generator, params, dev)[None]
    state = optimizer.init(row)

    def step(p, st):
        idx = next_idx().to(dev)
        with span("supervised.step"):
            loss, grads = mse_value_and_grad(model, layout, p, x[idx][None], y[idx][None])
            p, st = optimizer.update(grads, st, p)
        return p, st, loss[0]

    def val_loss(p):
        with span("supervised.eval"):
            return val_mse(model, layout, p[0], val_x, val_y)

    history: list[dict] = []
    ee = eval_every if do_eval else 0

    def body(c, t):
        p, st, best_v, best_p = c
        p, st, loss = step(p, st)
        v = chunked.boundary_val(val_loss, p, t, ee, dev)
        # a NaN val (off-boundary or diverged) never improves: the
        # comparison is False
        improved = v < best_v
        return (p, st, torch.where(improved, v, best_v), torch.where(improved, p, best_p)), (loss, v)

    def chunk_fn(c, stop, t0, size):
        return chunked.scan_rounds(body, c, range(t0, t0 + size), stop,
                                   patience=patience)

    carry = (row, state, torch.full((), float("inf"), device=dev), row.clone())
    row, _, best_v, best = chunked.run_chunks(
        chunk_fn, carry, total=steps, chunk=chunk, device=dev, eval_every=ee,
        patience=patience, history=history, round_key="step")
    use_best = val is not None and bool(torch.isfinite(best_v))
    return layout.row((best if use_best else row)[0]), history
