"""Learning-rate schedules: callables of the integer step tensor (the
counterpart of ``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full(step.shape, lr, dtype=torch.float32, device=step.device)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def fn(step):
        frac = torch.clip(step.to(torch.float32) / decay_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * frac))
        return lr * ((1 - alpha) * cos + alpha)

    return fn


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int, alpha: float = 0.0):
    cos = cosine_decay(lr, max(decay_steps - warmup_steps, 1), alpha)

    def fn(step):
        step_f = step.to(torch.float32)
        warm = lr * step_f / max(warmup_steps, 1)
        return torch.where(step_f < warmup_steps, warm, cos(step - warmup_steps))

    return fn
