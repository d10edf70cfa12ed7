"""The gossip pipeline, resolved once per trainer: the single-process
subset of ``repro.core.gossip_plan``.

A :class:`GossipPlan` holds every knob decision:

  * the representation of the round's mixing operator, ``"dense"``
    (the (N, N) ``mixing_matrix``) or ``"sparse"`` (the (N, B+1)
    neighbor table); ``"auto"`` picks sparse once ``N >= 4 (B + 1)``;
  * the mixer: ``"tree"`` (the plain PyTorch reference contractions) or
    ``"kernel"`` (the hand-written CUDA kernels on the card);
  * the local-DP stage: the kernel mixer fuses noise, mix and the clean
    self-restore into one pass; the tree mixer composes them
    (noise-add -> mix -> self-restore), as the JAX package does;
  * the gossip schedule, ``gossip_impl``: on one process every mix is
    the JAX package's ``"allgather"`` schedule, and ``"masked"`` adds
    the pairwise-mask cancellation term of ``core.secure_agg`` to the
    final mixed state, after the DP stage, so a masked run is the
    bitwise twin of its unmasked one on every mixer, representation
    and DP setting.  ``"auto"`` resolves to ``"allgather"``
    (:func:`choose_gossip_impl`).

The sweep engine (``GluADFL.train_sweep``) runs G scenarios' stacked
``(G·N, D)`` rows through :meth:`GossipPlan.sweep_gossip` on the tree
mixer only, as the JAX package does (:meth:`GossipPlan.require_sweep`
refuses the kernel mixer): the dense operator is a batched
``(G, N, N) @ (G, N, D)``, the sparse one a single gather over the
``(G·N, B+1)`` table with scenario g's indices offset by ``g·N``.

The sharded mixer and the schedules that need it (``"psum"``,
``"gather"``) are not ported yet and raise here, at construction;
multi-host runs are refused by the training CLI.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from torch.profiler import record_function

from repro_torch.core.gossip import (
    gossip_dp_composed,
    gossip_mix_masked,
    gossip_mix_sparse_tree,
    gossip_mix_tree,
)
from repro_torch.core.topology import mixing_matrix, neighbor_candidates, neighbor_table
from repro_torch.kernels import ops

MIXERS = ("tree", "kernel")
GOSSIP_REPRS = ("dense", "sparse")
NOT_PORTED_MIXERS = ("sharded",)
GOSSIP_IMPLS = ("allgather", "masked")
# the JAX package's schedules that only its sharded mixer runs
SHARDED_IMPLS = ("psum", "gather")

# the JAX package's refusal of a swept kernel mixer, in the port's terms
SWEEP_REFUSAL = ("train_sweep batches the tree mixer; mixer='kernel' (the CUDA kernels) "
                 "is a per-scenario program -- use serial train() for it")

# sparse tables win once the kept row (B+1 entries) is a small fraction
# of N; 4x covers the gather bookkeeping the dense matmul doesn't pay
SPARSE_GOSSIP_FACTOR = 4


class GossipPlanError(ValueError):
    """A knob value or combination this port does not run."""


def choose_gossip_repr(num_nodes: int, comm_batch: int, *,
                       factor: int = SPARSE_GOSSIP_FACTOR) -> str:
    """``--gossip-repr auto``: the sparse table once
    ``num_nodes >= factor * (comm_batch + 1)`` (sparse at the paper's
    N=226, B=7; dense at ohiot1dm's N=12)."""
    return "sparse" if num_nodes >= factor * (comm_batch + 1) else "dense"


def choose_gossip_impl(*, secure: bool = False) -> str:
    """``--gossip-impl auto`` on one process: ``"masked"`` when secure
    aggregation is asked for, else ``"allgather"`` (the JAX package's
    answer with one shard, where the gathered federation always fits)."""
    return "masked" if secure else "allgather"


@dataclass(frozen=True, eq=False)
class GossipPlan:
    """One resolved mixing pipeline; the round calls :meth:`build_repr`
    and :meth:`gossip`."""

    mixer: str
    gossip_repr: str                 # "dense" | "sparse", never "auto"
    gossip_impl: str                 # "allgather" | "masked", never "auto"
    comm_batch: int
    neighbor_cand: Any = None        # static-topology candidates (sparse)
    _mix: Callable = None
    _dp: Callable = None

    def build_repr(self, adj: torch.Tensor, active: torch.Tensor):
        """The round's operator: the (N, N) matrix or the ``(idx, wgt)``
        table built from a dense adjacency."""
        if self.gossip_repr == "sparse":
            return neighbor_table(adj, active, self.comm_batch)
        return mixing_matrix(adj, active, self.comm_batch)

    @property
    def masked(self) -> bool:
        return self.gossip_impl == "masked"

    def require_sweep(self) -> None:
        """Raise the JAX package's refusal unless the plan's mixer can
        batch a sweep grid (the tree mixer)."""
        if self.mixer != "tree":
            raise NotImplementedError(SWEEP_REFUSAL)

    def mask_table(self, operand, adj: torch.Tensor | None, active: torch.Tensor):
        """The (N, B+1) neighbor table the masks are drawn over: the
        operand itself under the sparse representation (also the
        candidate-built table of a static topology), else a table built
        from the round's adjacency beside the dense matrix, for the
        masks alone."""
        if self.gossip_repr == "sparse":
            return operand
        return neighbor_table(adj, active, self.comm_batch)

    def gossip(self, premix: torch.Tensor, operand, active: torch.Tensor,
               noise: torch.Tensor | None = None, mask_ctx=None) -> torch.Tensor:
        """One round's mixing step; ``noise`` is the (N, D) DP noise
        already scaled by sigma, or None when DP is off.  ``mask_ctx``,
        ``(mask source, adjacency)`` on a masked plan, adds the
        cancellation term after the mix and the DP stage, inside a
        ``round.secure_mask`` span (the table, the masks and the term)."""
        if noise is None:
            out = self._mix(premix, operand, active)
        else:
            out = self._dp(premix, noise, operand, active)
        if mask_ctx is not None:
            source, adj = mask_ctx
            with record_function("round.secure_mask"):
                idx, wgt = self.mask_table(operand, adj, active)
                out = gossip_mix_masked(out, idx, wgt, source(idx, wgt))
        return out

    def sweep_gossip(self, premix: torch.Tensor, operand, active: torch.Tensor,
                     noise: torch.Tensor | None = None, mask_ctx=None) -> torch.Tensor:
        """One swept round's mixing step over G scenarios: ``premix`` and
        ``noise`` (G·N, D), row ``g·N + n`` node n of scenario g;
        ``operand`` the stacked (G, N, N) matrices or (G, N, B+1)
        tables of :meth:`build_repr`; ``active`` (G, N).  The sparse
        tables become one (G·N, B+1) table, scenario g's indices offset
        by ``g·N``.  ``mask_ctx``, ``(G mask sources, (G, N, N)
        adjacency)`` on a masked plan, adds each scenario's
        cancellation term from its own source, scenario by scenario
        (one scenario's masks at a time)."""
        self.require_sweep()
        g, n = active.shape
        flat = operand
        if self.gossip_repr == "sparse":
            idx, wgt = operand
            offset = (torch.arange(g, dtype=idx.dtype, device=idx.device) * n)[:, None, None]
            flat = ((idx + offset).view(g * n, -1), wgt.reshape(g * n, -1))
        out = self.gossip(premix, flat, active.reshape(-1), noise)
        if mask_ctx is not None:
            sources, adj = mask_ctx
            with record_function("round.secure_mask"):
                idx, wgt = self.mask_table(operand, adj, active)
                rows = out.view(g, n, -1)
                out = torch.cat([gossip_mix_masked(rows[s], idx[s], wgt[s],
                                                   sources[s](idx[s], wgt[s]))
                                 for s in range(g)])
        return out


def _tree_stages(sparse: bool) -> tuple[Callable, Callable]:
    """The tree mixer: the reference contractions, DP composed."""
    if sparse:
        def mix(w, op, active):
            return gossip_mix_sparse_tree(w, op[0], op[1], active)
    else:
        def mix(w, op, active):
            # dense identity rows already encode inactivity, as in the JAX tree path
            return gossip_mix_tree(w, op)

    def dp(premix, noise, op, active):
        return gossip_dp_composed(mix, premix, noise, op, active)
    return mix, dp


def _kernel_stages(sparse: bool) -> tuple[Callable, Callable]:
    """The kernel mixer: ``kernels.ops``, DP fused into the kernel."""
    if sparse:
        return (lambda w, op, active: ops.gossip_mix_sparse(op[0], op[1], w, active),
                lambda premix, noise, op, active: ops.gossip_mix_sparse_dp(
                    op[0], op[1], premix, noise, active))
    return (lambda w, op, active: ops.gossip_mix(op, w, active),
            lambda premix, noise, op, active: ops.gossip_mix_dp(op, premix, noise, active))


def resolve_gossip_plan(
    *,
    mixer: str | None = None,
    gossip_impl: str = "allgather",
    gossip_repr: str = "dense",
    num_nodes: int,
    comm_batch: int,
    topology: str | None = None,
    cluster_size: int = 4,
    device=None,
) -> GossipPlan:
    """Resolve the knobs into a :class:`GossipPlan`, or raise
    :class:`GossipPlanError` naming the knob.  For a static topology
    under the sparse representation, the neighbor candidates are built
    here once (on ``device``), so no (N, N) array is built per round."""
    mixer = "tree" if mixer is None else mixer
    if mixer in NOT_PORTED_MIXERS:
        raise GossipPlanError(f"mixer={mixer!r} is not ported to PyTorch yet; this port "
                              f"runs mixer in {MIXERS} on one process")
    if mixer not in MIXERS:
        raise GossipPlanError(f"mixer {mixer!r} not in {MIXERS}")
    if gossip_impl == "auto":
        gossip_impl = choose_gossip_impl()
    if gossip_impl in SHARDED_IMPLS:
        raise GossipPlanError(f"gossip_impl={gossip_impl!r} needs the sharded mixer, which is "
                              f"not ported to PyTorch yet; this port runs gossip_impl in "
                              f"{GOSSIP_IMPLS} on one process")
    if gossip_impl not in GOSSIP_IMPLS:
        raise GossipPlanError(f"gossip_impl {gossip_impl!r} not in {GOSSIP_IMPLS} or 'auto'")
    if gossip_repr == "auto":
        gossip_repr = choose_gossip_repr(num_nodes, comm_batch)
    if gossip_repr not in GOSSIP_REPRS:
        raise GossipPlanError(f"gossip_repr {gossip_repr!r} not in {GOSSIP_REPRS} or 'auto'")
    sparse = gossip_repr == "sparse"
    mix_fn, dp_fn = (_kernel_stages if mixer == "kernel" else _tree_stages)(sparse)
    cand = None
    if sparse and topology is not None:
        cand = neighbor_candidates(topology, num_nodes, cluster_size)
        if cand is not None and device is not None:
            cand = tuple(t.to(device) for t in cand)
    return GossipPlan(mixer, gossip_repr, gossip_impl, comm_batch, cand, mix_fn, dp_fn)
