"""Functional optimizers (the counterpart of ``repro.optim.optimizers``).

``init(params) -> state`` and ``update(grads, state, params) ->
(new_params, new_state)`` act on the trainer's flat ``(N, D)`` buffer:
row n is node n, and every state leaf carries the same leading node
axis (``step`` is ``(N,)`` int32, as the JAX package's per-node scalar
stacked by ``vmap``), so the trainer's active mask selects whole rows.

The update rules keep the JAX package's order of operations: Adam
bias-corrects ``m`` and ``v`` separately, takes
``mhat / (sqrt(vhat) + eps)``, and adds weight decay to that step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

State = dict[str, torch.Tensor | None]


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[torch.Tensor], State]
    update: Callable[[torch.Tensor, State, torch.Tensor], tuple[torch.Tensor, State]]


def _lr_of(lr: float | Callable) -> Callable:
    """The per-node learning rate at ``step`` (N,) as something that
    broadcasts against (N, D): the float itself, or a schedule's
    (N,) values as a column."""
    if not callable(lr):
        return lambda step: lr
    return lambda step: torch.as_tensor(lr(step), dtype=torch.float32).reshape(-1, 1)


def _zero_step(params: torch.Tensor) -> torch.Tensor:
    return torch.zeros(params.shape[0], dtype=torch.int32, device=params.device)


def sgd(lr: float | Callable, momentum: float = 0.0) -> Optimizer:
    lr_fn = _lr_of(lr)

    def init(params):
        return {"step": _zero_step(params),
                "mu": torch.zeros_like(params) if momentum else None}

    def update(grads, state, params):
        step = state["step"] + 1
        cur_lr = lr_fn(step)
        if momentum:
            mu = momentum * state["mu"] + grads
            return params - cur_lr * mu, {"step": step, "mu": mu}
        return params - cur_lr * grads, {"step": step, "mu": None}

    return Optimizer(init, update)


def adam(
    lr: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = _lr_of(lr)

    def init(params):
        return {"step": _zero_step(params), "m": torch.zeros_like(params),
                "v": torch.zeros_like(params)}

    def update(grads, state, params):
        step = state["step"] + 1
        cur_lr = lr_fn(step)
        m = b1 * state["m"] + (1 - b1) * grads
        v = b2 * state["v"] + (1 - b2) * torch.square(grads)
        step_f = step.to(torch.float32)[:, None]
        bc1 = 1 - torch.pow(b1, step_f)
        bc2 = 1 - torch.pow(b2, step_f)
        mhat = m / bc1
        vhat = v / bc2
        step_ = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            step_ = step_ + weight_decay * params
        return params - cur_lr * step_, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adamw(lr: float | Callable = 1e-3, weight_decay: float = 0.01, **kw) -> Optimizer:
    return adam(lr, weight_decay=weight_decay, **kw)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adam":
        return adam(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise KeyError(f"unknown optimizer {name!r}")
