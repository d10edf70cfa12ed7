"""The chunk engine the baseline trainers share (the counterpart of
``repro.core.chunked``).

The JAX package runs a chunk of rounds as one donated ``lax.scan``
program; here a chunk is a host loop over rounds whose losses and eval
records stay on the device until the chunk ends, when the host reads
them once.  The baselines -- FedAvg, MAML/MetaSGD and pooled
supervised training -- run through it:

  * :class:`StopState` + :func:`scan_rounds` -- the early-stopping latch
    as 0-d tensors on the device.  With ``patience > 0`` every round's
    carry is where-selected on the latch's ``done`` flag, so once the
    val loss has failed to improve for ``patience`` consecutive evals
    the later rounds leave the carry bitwise unchanged and report NaN;
    the host reads ``stop_round`` once per chunk and stops dispatching.
    With ``patience == 0`` the rounds run unguarded, the same arithmetic
    as the per-round loop engine.
  * :func:`boundary_val` -- the NaN-sentinel streaming eval: the host
    knows the round index, so the eval runs only on the
    ``(t + 1) % eval_every == 0`` boundaries and NaN stands elsewhere.
  * :func:`read_chunk` + :func:`drain_history` -- the once-per-chunk
    host sync and the history records it becomes, truncated after an
    early stop.
  * :func:`dispatch_chunk` -- the single chokepoint through which every
    trainer runs a chunk, so a test can count chunks (the Table-4
    method grid in <= 4).

It also holds what the three trainers share around their chunks: the
engine choice (``"loop"`` is the scan engine at one round a chunk and
no early stop, so a sync every round and, without patience, bitwise the
same numbers), the initial flat param
row, the draw stream, the validation MSE and the refusal of a custom
loss.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch.models.base import Model, Params
from repro_torch.utils.pytree import ParamLayout
from repro_torch.utils.tracing import span

# Default rounds per chunk for engine="scan"; the trainers clamp it to
# the requested round count.
DEFAULT_CHUNK = 128

LOSS_FN_REFUSAL = "a custom loss_fn is not ported; the baselines train on the MSE"
ENGINES = ("scan", "loop")


def engine_chunk(engine: str, chunk: int | None, patience: int) -> tuple[int | None, int]:
    """The chunk size and early-stop patience ``engine`` runs at:
    ``(chunk, patience)`` for ``"scan"``, ``(1, 0)`` for ``"loop"`` (the
    JAX package's per-round oracle, eager here, so the scan engine with
    a sync every round is the same program; like the oracle it trains
    and records every round whatever the patience)."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}")
    return (1, 0) if engine == "loop" else (chunk, patience)


def initial_row(model: Model, layout: ParamLayout, generator, params: Params | None,
                device) -> torch.Tensor:
    """The run's initial params as a flat (D,) row on ``device``: the
    given ``params`` dict, else ``model.init(generator)``."""
    if params is None:
        params = model.init(generator, device=device)
    return layout.flatten({k: torch.as_tensor(params[k])[None] for k in layout.names})[0].to(device)


def val_mse(model: Model, layout: ParamLayout, row: torch.Tensor, val_x: torch.Tensor,
            val_y: torch.Tensor) -> torch.Tensor:
    """``mean((apply(params, val_x) - val_y)^2)`` of one (D,) row, 0-d on
    the device (on CUDA the LSTM's forward is ``lstm_forward``)."""
    with torch.no_grad():
        pred = model.apply(layout.row(row), val_x)
        return torch.mean(torch.square(pred - val_y))


def val_tensors(val_data, device):
    if val_data is None:
        return None, None
    return tuple(torch.as_tensor(np.asarray(v, np.float32)).to(device) for v in val_data)


def draw_stream(draws: Iterable | None, fresh: Callable, name: str) -> Callable:
    """A callable giving the next round's draws: from ``draws`` when
    given, else ``fresh()``; inside the span ``name``."""
    stream = None if draws is None else iter(draws)

    def nxt():
        with span(name):
            return next(stream) if stream is not None else fresh()

    return nxt


@dataclass
class StopState:
    """Early-stopping latch, 0-d tensors on the trainer's device.

    ``done`` freezes the run; ``best_val``/``bad_evals`` implement
    patience; ``stop_round`` records the round the latch tripped (-1 =
    never) so the host can truncate the history exactly."""

    done: torch.Tensor        # () bool
    best_val: torch.Tensor    # () float32
    bad_evals: torch.Tensor   # () int32
    stop_round: torch.Tensor  # () int32


def init_stop(device) -> StopState:
    return StopState(
        done=torch.zeros((), dtype=torch.bool, device=device),
        best_val=torch.full((), float("inf"), dtype=torch.float32, device=device),
        bad_evals=torch.zeros((), dtype=torch.int32, device=device),
        stop_round=torch.full((), -1, dtype=torch.int32, device=device),
    )


def update_stop(stop: StopState, val: torch.Tensor, t: int, patience: int) -> StopState:
    """Fold one round's (possibly NaN-sentinel) val loss into the latch.

    NaN (an off-boundary round, or a diverged eval) never improves and
    never counts against patience -- only real evals move the state."""
    has_val = torch.isfinite(val)
    improved = has_val & (val < stop.best_val)
    best = torch.where(improved, val, stop.best_val)
    bad = torch.where(has_val, torch.where(improved, 0, stop.bad_evals + 1),
                      stop.bad_evals).to(torch.int32)
    trip = has_val & (bad >= patience) & ~stop.done
    return StopState(
        done=stop.done | trip,
        best_val=best,
        bad_evals=bad,
        stop_round=torch.where(trip, t, stop.stop_round).to(torch.int32),
    )


def boundary_val(val_fn: Callable, params, t: int, eval_every: int,
                 device) -> torch.Tensor:
    """``val_fn(params)`` (0-d float32) at ``(t+1) % eval_every == 0``
    boundaries, NaN (the host-side sentinel) elsewhere;
    ``eval_every == 0`` never evaluates."""
    if eval_every and (t + 1) % eval_every == 0:
        return val_fn(params).to(torch.float32)
    return torch.full((), float("nan"), dtype=torch.float32, device=device)


def _select(done: torch.Tensor, old, new):
    """``old`` where the latch is set, else ``new``, through tuples,
    lists and dicts of tensors (None stays None)."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: _select(done, old[k], v) for k, v in new.items()}
    if isinstance(new, (tuple, list)):
        return type(new)(_select(done, o, n) for o, n in zip(old, new))
    return torch.where(done, old, new)


def scan_rounds(body: Callable, carry: Any, ts: range, stop: StopState | None = None,
                *, patience: int = 0):
    """Run ``body(carry, t) -> (carry, (loss, val))`` over the round
    indices ``ts`` without a host sync.

    Returns ``(carry, stop, (losses, vals))``, the last two (len(ts),)
    tensors on the device.  With ``patience == 0`` the rounds run as-is
    and ``stop`` passes through; with ``patience > 0`` each round's new
    carry, loss and val are where-selected on ``stop.done`` (a stopped
    round keeps the carry bitwise and reports NaN) and
    :func:`update_stop` advances the latch from the round's val."""
    losses, vals = [], []
    for t in ts:
        new, (loss, val) = body(carry, t)
        if patience:
            if stop is None:
                stop = init_stop(loss.device)
            nan = torch.full_like(loss, float("nan"))
            carry = _select(stop.done, carry, new)
            loss = torch.where(stop.done, nan, loss)
            val = torch.where(stop.done, nan, val)
            stop = update_stop(stop, val, t, patience)
        else:
            carry = new
        losses.append(loss)
        vals.append(val)
    return carry, stop, (torch.stack(losses), torch.stack(vals))


def dispatch_chunk(chunk_fn: Callable, *args, **kwargs):
    """Run one chunk.

    Every baseline trainer runs its chunks through this single
    chokepoint, so a test can monkeypatch it with a counting wrapper and
    pin how many chunks a workload dispatches (the Table-4 method grid
    at <= 4)."""
    return chunk_fn(*args, **kwargs)


def read_chunk(losses: torch.Tensor, vals: torch.Tensor, stop: StopState | None):
    """The chunk's one host sync: its losses and vals as float32 numpy
    arrays and the latch's ``stop_round`` (-1 without a latch), copied
    to the host together."""
    parts = [losses.to(torch.float32), vals.to(torch.float32)]
    if stop is not None:
        parts.append(stop.stop_round.to(torch.float32).reshape(1))
    with span("chunk.sync"):
        host = torch.cat(parts).cpu().numpy()
    c = losses.shape[0]
    stop_round = int(host[2 * c]) if stop is not None else -1
    return host[:c], host[c:2 * c], stop_round


def drain_history(history: list, losses, vals, t0: int, *,
                  eval_every: int = 0, stop_round: int = -1,
                  round_key: str = "round", val_key: str = "val_loss") -> bool:
    """Append one chunk's records to ``history`` (host side, one sync
    per chunk).  ``losses``/``vals`` are the chunk's ``(c,)`` arrays
    (``vals`` may be ``None`` when eval is off); rounds after an early
    stop (``stop_round >= 0``) carry NaN sentinels and are dropped.
    Returns True once the stop round has been drained."""
    c = len(losses)
    for i in range(c):
        r = t0 + i
        if 0 <= stop_round < r:
            return True
        rec = {round_key: r, "loss": float(losses[i])}
        if vals is not None and eval_every and (r + 1) % eval_every == 0:
            rec[val_key] = float(vals[i])
        history.append(rec)
    return 0 <= stop_round < t0 + c


def run_chunks(chunk_fn: Callable, carry, *, total: int, chunk: int | None, device,
               eval_every: int, patience: int, history: list,
               round_key: str = "round"):
    """The scan engine's outer loop, shared by the trainers: dispatch
    ``chunk_fn(carry, stop, t0, c) -> (carry, stop, (losses, vals))``
    through :func:`dispatch_chunk` for chunks of ``chunk`` rounds
    (default :data:`DEFAULT_CHUNK`, at most ``total``) until ``total``
    rounds ran or the latch tripped, draining each chunk into
    ``history``.  Returns the final carry."""
    chunk = max(1, min(chunk or DEFAULT_CHUNK, total))
    stop = init_stop(device) if patience else None
    t = 0
    while t < total:
        c = min(chunk, total - t)
        carry, stop, (losses, vals) = dispatch_chunk(chunk_fn, carry, stop, t, c)
        host_losses, host_vals, stop_round = read_chunk(losses, vals, stop)
        stopped = drain_history(history, host_losses, host_vals if eval_every else None, t,
                                eval_every=eval_every, stop_round=stop_round,
                                round_key=round_key)
        t += c
        if stopped:
            break
    return carry
