"""Gossip parameter mixing, the paper's Step 2+3, on the federation's
flat ``(N, D)`` parameter matrix (the counterpart of
``repro.core.gossip``).

The JAX package mixes leaf by leaf; here the whole matrix is mixed at
once, which is the same arithmetic per column.  This module holds the
reference ("tree") contractions in plain PyTorch and the composed
local-DP stage the tree mixer runs; the kernel mixer calls
``kernels.ops`` (the hand-written CUDA kernels for CUDA tensors, their
plain twins for CPU tensors), whose DP variants fuse the same stage
into one pass.  :func:`gossip_mix_masked` adds the secure-aggregation
term of ``core.secure_agg`` after any of them.  ``core.gossip_plan``
picks among them once per trainer.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.secure_agg import masked_mix_zero


def gossip_mix_tree(w: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """Dense reference: ``out = mix @ w`` (identity rows keep inactive
    nodes' rows, for finite data).  A sweep's (G, N, N) ``mix`` mixes
    its (G·N, D) ``w`` block by block, as one batched matmul."""
    return (mix.to(torch.float32) @ w.view(*mix.shape[:-1], -1)).view(w.shape)


def gossip_mix_sparse_tree(w: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                           active: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse reference: ``out[n] = sum_b wgt[n,b] w[idx[n,b]]``; with
    ``active``, inactive rows are where-selected copies of ``w``."""
    out = torch.einsum("nb,nbd->nd", wgt.to(torch.float32), w[idx.long()])
    if active is not None:
        out = torch.where(active[:, None] > 0, out, w)
    return out


def gossip_dp_composed(mix_fn: Callable, premix: torch.Tensor, noise: torch.Tensor,
                       operand, active: torch.Tensor, rows: slice = slice(None)) -> torch.Tensor:
    """Local DP composed from a plain mix: neighbours mix the noised
    view ``premix + noise``, then each node re-adds its own clean
    self-contribution (``noise`` is already scaled by sigma).

    Dense (``operand`` (N, N), or a sweep's (G, N, N) on (G·N, D)
    rows): ``mix(W + Z) - diag(M) Z``; inactive rows are left to the
    trainer's where-mask, as in the JAX package.  Sparse (``operand``
    the ``(idx, wgt)`` table, slot 0 self, so ``wgt[:, 0]`` is the
    diagonal): the same, and since the plain mix selected inactive rows
    back to the noised view, they are restored to the clean premix.
    ``premix`` and ``noise`` hold the global ``rows`` of a global
    ``operand`` and ``active`` (a rank's block on the sharded mixer; on
    the swept-sharded engine, those rows of each of its scenarios'
    (Gb, N, ...) operators, flat as ``(Gb·k, D)``)."""
    mixed_noisy = mix_fn(premix + noise, operand, active)
    if isinstance(operand, tuple):
        out = mixed_noisy - operand[1][..., rows, :1].reshape(-1, 1) * noise
        return torch.where(active[..., rows].reshape(-1, 1) > 0, out, premix)
    diag = torch.diagonal(operand, dim1=-2, dim2=-1)[..., rows]
    return mixed_noisy - diag.reshape(-1, 1) * noise


def gossip_mix_masked(mixed: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                      masks: torch.Tensor) -> torch.Tensor:
    """Secure-aggregation wrapper (``gossip_impl="masked"``): add the
    pairwise-mask cancellation term to an already-mixed (N, D) state.
    The term is exactly ``+0.0`` everywhere, so the result is bitwise
    ``mixed`` (a ``-0.0`` becomes ``+0.0``, as in the JAX package),
    while the masks are really drawn and summed.  ``(idx, wgt)`` is the
    round's (N, B+1) neighbor table and ``masks`` its (N, P, D) masks
    (``core.secure_agg``); it follows any mixer, dense or sparse."""
    return mixed + masked_mix_zero(idx, wgt, masks)
