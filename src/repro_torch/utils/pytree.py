"""Parameter-dict helpers (the counterpart of ``repro.utils.pytree``).

Parameters are plain ``dict[str, Tensor]``.  Flat vectors concatenate
the leaves in sorted-key order, which is the order ``jax.tree.leaves``
gives a dict (``b, b_out, w_out, wh, wx`` for the LSTM), so a
checkpoint's ``vec`` written by either launcher loads in the other.

The trainer keeps a whole federation in one ``(N, D)`` buffer:
:class:`ParamLayout` maps it to named per-leaf views ``(N, *shape)`` in
that same order, so a gossip contraction runs once on the whole matrix
instead of once per leaf (each column's arithmetic is the same) and the
optimizer updates the flat buffer directly.

The LM zoo's params are nested dicts and lists of tensors:
:func:`tree_leaves`, :func:`tree_map` and :func:`tree_unflatten` walk
them in ``jax.tree``'s order (dict keys sorted, lists in order).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

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


def tree_leaves(tree, *, is_leaf=None) -> list:
    """The leaves of nested dicts, lists and tuples, dict keys sorted
    (``jax.tree.leaves``' order); a node for which ``is_leaf`` is true
    is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k], is_leaf=is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t, is_leaf=is_leaf)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, leaf by leaf; the structure kept (a tuple
    comes back a list)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, *, is_leaf=None):
    """``fn(path, leaf)`` over the leaves of nested dicts, lists, tuples
    and dataclasses, ``path`` the tuple of keys from the root (a dict's
    key, a list's index, a dataclass's field name), as
    ``jax.tree_util.tree_map_with_path`` gives them; the structure kept
    (a tuple comes back a tuple, a dataclass as its class).  A node for
    which ``is_leaf`` is true is a leaf."""

    def walk(path, t):
        if is_leaf is not None and is_leaf(t):
            return fn(path, t)
        if isinstance(t, dict):
            return {k: walk(path + (k,), v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(path + (i,), v) for i, v in enumerate(t))
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return type(t)(**{f.name: walk(path + (f.name,), getattr(t, f.name))
                              for f in dataclasses.fields(t)})
        return fn(path, t)

    return walk((), tree)


def tree_unflatten(like, leaves):
    """``leaves``, in :func:`tree_leaves`' order, in the structure of
    ``like`` (its dicts keep their key order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(like)


def tree_index(stacked: dict[str, torch.Tensor], i) -> dict[str, torch.Tensor]:
    """Entry ``i`` of every leaf's leading axis: one scenario's params
    out of a sweep's stacked (G, ...) populations."""
    return {k: v[i] for k, v in stacked.items()}


def tree_mean(stacked: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Mean over the leading (node) axis of every leaf."""
    return {k: v.mean(dim=0) for k, v in stacked.items()}


def tree_weighted_mix(stacked: dict[str, torch.Tensor], mix: torch.Tensor) -> dict[str, torch.Tensor]:
    """``out[n] = sum_m mix[n, m] * stacked[m]`` for every leaf, in
    float32: the reference gossip contraction on a stacked dict."""
    out = {}
    for k, leaf in stacked.items():
        flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
        out[k] = (mix.to(torch.float32) @ flat).to(leaf.dtype).reshape(leaf.shape)
    return out


@dataclass(frozen=True)
class ParamLayout:
    """Where each leaf of one node's params lives in a flat row of D
    floats: sorted names, their shapes and their offsets."""

    names: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    offsets: tuple[int, ...]
    dim: int

    @classmethod
    def of(cls, params: dict[str, torch.Tensor]) -> "ParamLayout":
        """The layout of one node's param dict (unstacked leaves)."""
        names = tuple(sorted(params))
        shapes = tuple(tuple(params[k].shape) for k in names)
        offsets, pos = [], 0
        for shape in shapes:
            offsets.append(pos)
            pos += math.prod(shape)
        return cls(names, shapes, tuple(offsets), pos)

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        """Named views ``(N, *shape)`` into a ``(N, D)`` buffer (no copy;
        gradients taken through them land in ``flat``)."""
        n = flat.shape[0]
        return {
            k: flat[:, o : o + math.prod(s)].view(n, *s)
            for k, s, o in zip(self.names, self.shapes, self.offsets)
        }

    def row(self, vec: torch.Tensor) -> dict[str, torch.Tensor]:
        """One node's params from a ``(D,)`` vector (views)."""
        return {k: v[0] for k, v in self.views(vec[None]).items()}

    def flatten(self, stacked: dict[str, torch.Tensor]) -> torch.Tensor:
        """A stacked dict (leaves ``(N, *shape)``) -> a new ``(N, D)``
        float32 buffer."""
        n = stacked[self.names[0]].shape[0]
        return torch.cat(
            [stacked[k].reshape(n, -1).to(torch.float32) for k in self.names], dim=1
        ).contiguous()
