"""Flat-vector views of a parameter dict (``repro.utils.pytree``'s
``tree_to_vector``/``vector_to_tree`` for the port).

Parameters are plain ``dict[str, Tensor]``.  The vector concatenates the
leaves in sorted-key order, which is the order ``jax.tree.leaves`` gives
a dict (``b, b_out, w_out, wh, wx`` for the LSTM), so a checkpoint's
``vec`` written by the JAX launcher loads unchanged.
"""
from __future__ import annotations

import torch


def tree_to_vector(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    """Concatenate the row-major leaves in sorted-key order."""
    return torch.cat([tree[k].reshape(-1) for k in sorted(tree)])


def vector_to_tree(vec: torch.Tensor, like: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Inverse of :func:`tree_to_vector` given a template dict (its
    shapes and dtypes; ``vec``'s device)."""
    n_total = sum(like[k].numel() for k in like)
    if vec.numel() != n_total:
        raise ValueError(f"vector has {vec.numel()} values, template {n_total}")
    out, pos = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = vec[pos : pos + n].reshape(like[k].shape).to(like[k].dtype)
        pos += n
    return out
