"""Uniform model interface (the counterpart of ``repro.models.base``).

A :class:`Model` bundles plain functions on parameter dicts:

  init(generator)          -> params dict
  apply(params, x)         -> (B,) prediction from (B, L) history, one
                              weight set shared by every row
  apply_rows(stacked, x)   -> (G,) prediction with one weight set per
                              row (``stacked`` leaves carry a leading G)
  apply_nodes(stacked, x)  -> (N, B) prediction of node n's batch
                              x[n] under node n's weights, in plain
                              differentiable ops (the trainer's loss)
  apply_groups(stacked, x) -> (G, R) prediction of the shared (R, L)
                              windows under each group's weights (a
                              sweep's G population models)

``apply_rows`` and ``apply_nodes`` replace the ``vmap`` of ``apply``
that the JAX package uses over stacked params.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device

Params = dict[str, torch.Tensor]


@dataclass(frozen=True)
class Model:
    name: str
    init: Callable[..., Params]
    apply: Callable[[Params, torch.Tensor], torch.Tensor]
    apply_rows: Callable[[Params, torch.Tensor], torch.Tensor]
    apply_nodes: Callable[[Params, torch.Tensor], torch.Tensor]
    apply_groups: Callable[[Params, torch.Tensor], torch.Tensor]


def params_from_numpy(np_params: Mapping[str, Any], device=None) -> Params:
    """Carry a parameter dict of arrays (numpy, or anything
    ``np.asarray`` takes, such as JAX arrays) into float32 tensors on
    ``device`` (default CUDA).  The tensors own their memory."""
    dev = resolve_device(device)
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
        for k, v in np_params.items()
    }
