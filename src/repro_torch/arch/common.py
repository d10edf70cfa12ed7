"""Shared pieces of the architecture assemblies (a port of the
inference half of ``repro.arch.common``): the compute-dtype cast, the
masked cross entropy, the sinusoidal positions, and the helpers that
carry a JAX param tree across and build and index the L-stacked trees.
The zoo's train step (``TrainState``, ``adam_apply``,
``make_train_step``) waits for a later slice (ROADMAP Queue 1 item
15.5)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

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


def params_from_numpy(tree: PyTree, cfg, device=None) -> PyTree:
    """A JAX param tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``: nested dicts and lists, stacked leaves as they are) as the
    port's: the same structure, each leaf a tensor in ``cfg.dtype`` on
    ``device`` (CUDA unless the CPU is asked for), as JAX's
    ``cast_params`` gives every fp32 leaf at each call."""
    dev, dtype = resolve_device(device), compute_dtype(cfg.dtype)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, cfg, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, cfg, dev) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=dev).to(dtype)


def put_stacked(stacked: dict, tree: dict, i: int, n: int) -> None:
    """``tree``'s leaves into slot i of the n-stacked nested dict (each
    leaf allocated at its first slot)."""
    for name, t in tree.items():
        if isinstance(t, dict):
            put_stacked(stacked.setdefault(name, {}), t, i, n)
            continue
        if name not in stacked:
            stacked[name] = t.new_empty((n, *t.shape))
        stacked[name][i] = t


def index_stacked(tree: dict, i: int) -> dict:
    """Slot i of an L-stacked nested dict."""
    return {k: index_stacked(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the positions with label >= 0, in fp32, without
    one-hots.  logits (B, S, V) of any dtype; labels (B, S) int."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return ((lse - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) fp32 table: the sines of the angles, then their cosines."""
    pos = torch.arange(seq, device=device, dtype=torch.float32)[:, None]
    inv = torch.exp(-torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim
                    * torch.log(torch.tensor(10000.0)))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[:, :dim]
