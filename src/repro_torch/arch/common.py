"""Shared pieces of the architecture assemblies (a port of the
inference half of ``repro.arch.common``): the compute-dtype cast and the
masked cross entropy.  The zoo's train step (``TrainState``,
``adam_apply``, ``make_train_step``) waits for a later slice (ROADMAP
Queue 1 item 15)."""
from __future__ import annotations

from typing import Any

import torch

PyTree = Any


def compute_dtype(name: str) -> torch.dtype:
    """``ArchConfig.dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def cast_params(params: PyTree, dtype: torch.dtype) -> PyTree:
    """Every fp32 leaf of nested dicts and lists of tensors cast to the
    compute dtype (the identity when that is fp32, or when the leaves
    already are in it, as the port's LM params are)."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [cast_params(v, dtype) for v in params]
    return params.to(dtype) if params.dtype == torch.float32 else params


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the positions with label >= 0, in fp32, without
    one-hots.  logits (B, S, V) of any dtype; labels (B, S) int."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
