"""Shared pieces of the architecture assemblies (a port of
``repro.arch.common``): the compute-dtype cast, the masked cross
entropy, the sinusoidal positions, the helpers that carry a JAX param
tree across and build, index and unstack the L-stacked trees, the
per-layer rematerialisation, and the zoo's train step
(:class:`TrainState`, :func:`init_train_state`, :func:`adam_apply`,
:func:`make_train_step`).

Training holds fp32 masters (``init_params(..., dtype=torch.float32)``
or ``params_from_numpy(..., dtype=torch.float32)``); each family's
``forward`` casts them to the compute dtype at entry with
:func:`cast_params`, and the gradient reaches the masters through that
cast, as in JAX.  The train step is plain PyTorch autograd: the JAX
package's train step reaches no Pallas kernel.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.arch.sharding import P, axes_size, placements
from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

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
    already are in it, as the port's serving params are); differentiable,
    so a gradient reaches fp32 masters through it."""
    return tree_map(lambda leaf: leaf.to(dtype) if leaf.dtype == torch.float32 else leaf, params)


def params_from_numpy(tree: PyTree, cfg, device=None, dtype: torch.dtype | None = None) -> PyTree:
    """A JAX param tree as numpy arrays (``jax.tree.map(np.asarray,
    params)``: nested dicts and lists, stacked leaves as they are) as the
    port's: the same structure, each leaf a tensor on ``device`` (CUDA
    unless the CPU is asked for) in ``dtype``, by default ``cfg.dtype``,
    as JAX's ``cast_params`` gives every fp32 leaf at each call; pass
    ``torch.float32`` for the fp32 masters of a train state."""
    dev, dtype = resolve_device(device), dtype or compute_dtype(cfg.dtype)
    return tree_map(lambda leaf: torch.tensor(np.asarray(leaf, dtype=np.float32),
                                              device=dev).to(dtype), tree)


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


def unstack(tree: dict) -> list[dict]:
    """Every slot of an L-stacked nested dict, as views, by one
    ``torch.unbind`` a leaf (whose backward stacks the slots' gradients
    once, where indexing each slot would add an L-stacked zero tensor a
    slot)."""
    names = sorted(tree)
    parts = [unstack(tree[k]) if isinstance(tree[k], dict) else torch.unbind(tree[k])
             for k in names]
    return [dict(zip(names, slot)) for slot in zip(*parts)]


def remat(fn: Callable, *args):
    """``fn(*args)``; with grad mode on, under non-reentrant
    ``torch.utils.checkpoint``, so that the layer's activations are
    recomputed in the backward pass instead of kept (JAX's per-layer
    ``jax.checkpoint``).  ``fn`` must compute the same values when run
    again, which every layer body of the zoo does."""
    if torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over the positions with label >= 0, in fp32, without
    one-hots.  logits (B, S, V) of any dtype; labels (B, S) int."""
    logits = logits.float()
    labels = labels.long()
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # a gather along a sharded vocab dim leaves DTensor a masked
        # partial, and its backward a (B, S, V) zeros on every rank: the
        # same pick as a masked sum, sharded as the logits are
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(vocab == labels.clamp(min=0)[..., None], logits, 0.0).sum(dim=-1)
    else:
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


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """Params (fp32 masters that require grad), Adam's first and second
    moments, and the step, an int32 0-d tensor."""

    params: PyTree
    m: PyTree
    v: PyTree
    step: torch.Tensor


def _live(leaf: torch.Tensor) -> torch.Tensor:
    """The leaf as a tensor that requires grad (floating leaves; the
    same storage)."""
    return leaf.detach().requires_grad_() if leaf.is_floating_point() else leaf


def init_train_state(params: PyTree) -> TrainState:
    """Zero moments and step 0 on the params' device."""
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return TrainState(params=tree_map(_live, params), m=tree_map(torch.zeros_like, params),
                      v=tree_map(torch.zeros_like, params), step=step)


@torch.no_grad()
def adam_apply(state: TrainState, grads: PyTree, *, lr: float = 3e-4, b1: float = 0.9,
               b2: float = 0.95, eps: float = 1e-8) -> TrainState:
    """One Adam step, written out as JAX writes it: the moments, the
    bias corrections ``1 - b ** step`` of the new int step cast to fp32,
    and ``p - lr * (m / bc1) / (sqrt(v / bc2) + eps)``, op by op
    (``torch.optim.Adam`` divides in another order).  Returns a new
    state; the given one is not changed."""
    step = state.step + 1
    m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g, state.m, grads)
    v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g), state.v, grads)
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=stepf.device), stepf)
    params = tree_map(lambda p, m_, v_: _live(p - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)),
                      state.params, m, v)
    return TrainState(params=params, m=m, v=v, step=step)


def make_train_step(loss_fn: Callable[[PyTree, PyTree], torch.Tensor], *,
                    num_microbatches: int = 1, lr: float = 3e-4, data_axes: tuple[str, ...] = ()):
    """The gradient-accumulated train step ``step(state, batch) ->
    (new_state, {"loss", "grad_norm"})``.

    ``loss_fn(params, microbatch) -> scalar``.  Every leaf of ``batch``
    (B, ...) is split along dim 0 into ``num_microbatches`` equal
    microbatches; each gives one loss and one gradient (autograd), the
    gradients are summed in fp32 in microbatch order from zeros, and
    loss and gradients are divided by M, as JAX's ``lax.scan`` does.
    ``grad_norm`` is the square root of the summed squares of the
    (averaged) gradient's leaves.  The remat policy lives in
    ``loss_fn``, as in JAX.

    ``data_axes``: the mesh axes that carry the batch dim.  The
    microbatch reshape (B,) -> (M, B/M) must KEEP the batch shard on
    dim 1 (JAX's explicit constraint): on DTensor leaves, the reshaped
    batch is redistributed to ``(None, data_axes, None, ...)`` (an
    all-to-all), so each microbatch is spread over the data ranks; when
    M does not split over the data ranks, the batch rows are gathered
    before the reshape (DTensor cannot unflatten the shard there).  On
    plain tensors it is the plain reshape."""
    mb = num_microbatches

    def split(leaf):
        """(B, ...) -> (M, B/M, ...), the batch shard kept on dim 1."""
        shape = (mb, leaf.shape[0] // mb) + tuple(leaf.shape[1:])
        if not data_axes or not isinstance(leaf, DTensor):
            return leaf.reshape(shape)
        mesh = leaf.device_mesh
        if mb % axes_size(mesh, data_axes):
            # DTensor keeps a reshaped shard on dim 0 only if M splits
            # over the data ranks: gather the batch rows first
            leaf = leaf.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == 0
                                            else p for p in leaf.placements])
        leaf = leaf.reshape(shape)
        want = placements(P(None, data_axes, *([None] * (leaf.ndim - 2))), mesh)
        return leaf if tuple(leaf.placements) == want else leaf.redistribute(mesh, want)

    def value_and_grad(params, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(leaves, grads)]

    def train_step(state: TrainState, batch: PyTree):
        params = tree_map(_live, state.params)
        if mb == 1:
            loss, grads = value_and_grad(params, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
            micros = tree_map(split, batch)
            for i in range(mb):
                micro = tree_map(lambda leaf: leaf[i], micros)
                loss_i, grads_i = value_and_grad(params, micro)
                loss = loss + loss_i
                torch._foreach_add_(grads, grads_i)  # in place: JAX's sums, one buffer
                del grads_i
            loss = loss / mb
            torch._foreach_div_(grads, float(mb))
        new_state = adam_apply(state, tree_unflatten(params, grads), lr=lr)
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return train_step
