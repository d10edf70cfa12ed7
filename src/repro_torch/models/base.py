"""Uniform model interface (the counterpart of ``repro.models.base``).

A :class:`Model` bundles plain functions on parameter dicts:

  init(generator)          -> params dict
  apply(params, x)         -> (B,) prediction from (B, L) history, one
                              weight set shared by every row
  apply_nodes(stacked, x)  -> (N, B) prediction of node n's batch
                              x[n] under node n's weights, in plain
                              differentiable ops (every trainer's loss)
  apply_rows(stacked, x)   -> (G,) prediction with one weight set per
                              row (``stacked`` leaves carry a leading G)
  apply_groups(stacked, x) -> (G, R) prediction of the shared (R, L)
                              windows under each group's weights (a
                              sweep's G population models)
  forward_for_grad(layout, flat, x, y)
                           -> ((N,) MSE losses of ``apply_nodes`` at the
                              flat (N, D) params, a call returning their
                              (N, D) gradients), computed by hand

``apply_nodes`` and ``apply_rows`` replace the ``vmap`` of ``apply``
that the JAX package uses over stacked params.  ``apply_rows`` and
``apply_groups`` serve and sweep the LSTM; the baselines have neither
(None).  ``forward_for_grad`` is the LSTM's hand-written
backpropagation through time; ``core.gluadfl.mse_value_and_grad`` takes
it where a model has one and autograd through ``apply_nodes`` where it
has None (the baselines).

Params are flat ``dict[str, Tensor]``.  A model whose JAX params nest
(N-BEATS, N-HiTS: lists of blocks of dicts) keys its leaves by dotted
paths with zero-padded list indices (``blocks.0.layers.1.w``), so the
sorted keys run in ``jax.tree.leaves`` order; :func:`flatten_tree`
carries a nested JAX tree over.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device

Params = dict[str, torch.Tensor]


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable[..., Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    apply_nodes: Callable[[Params, torch.Tensor], torch.Tensor]
    apply_rows: Callable[[Params, torch.Tensor], torch.Tensor] | None = None
    apply_groups: Callable[[Params, torch.Tensor], torch.Tensor] | None = None
    forward_for_grad: Callable[..., tuple[torch.Tensor, Callable[[], torch.Tensor]]] | None = None


def leaf_key(*path) -> str:
    """The dotted key of a nested leaf, list indices as zero-padded
    ``(index, length)`` pairs: ``leaf_key("blocks", (0, 3), "w")`` is
    ``blocks.0.w``, and ``(3, 12)`` becomes ``03``."""
    return ".".join(f"{p[0]:0{len(str(p[1] - 1))}d}" if isinstance(p, tuple) else p
                    for p in path)


def flatten_tree(tree: Mapping[str, Any] | Sequence, *prefix) -> dict[str, Any]:
    """A nested tree of dicts and lists -> a flat dict of its leaves
    under :func:`leaf_key` keys (a flat dict comes back as it is)."""
    items = (tree.items() if isinstance(tree, Mapping)
             else (((i, len(tree)), v) for i, v in enumerate(tree)))
    out: dict[str, Any] = {}
    for k, v in items:
        if isinstance(v, (Mapping, list, tuple)):
            out.update(flatten_tree(v, *prefix, k))
        else:
            out[leaf_key(*prefix, k)] = v
    return out


def params_from_numpy(np_params: Mapping[str, Any], device=None) -> Params:
    """Carry a parameter tree of arrays (numpy, or anything
    ``np.asarray`` takes, such as JAX arrays; nested dicts and lists are
    flattened by :func:`flatten_tree`) into float32 tensors on
    ``device`` (default CUDA).  The tensors own their memory."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
        for k, v in flatten_tree(np_params).items()
    }


def get_model(name: str, history_len: int = 12, hidden: int = 128, **kw) -> Model:
    """The registered model ``name`` (``models.MODEL_REGISTRY``) as a
    :class:`Model`."""
    from repro_torch.models import MODEL_REGISTRY

    return MODEL_REGISTRY[name](history_len=history_len, hidden=hidden, **kw).as_model()
