"""Gossip data-parallelism (a port of ``repro.core.gossip_dp``): the
paper's algorithm with "patient phone" -> "data-parallel group".

Each node of gossip-DP is a data-parallel group that holds the full
parameters of an LM-zoo model and takes local optimizer steps on its
shard of the batch; every K steps the nodes mix their PARAMETERS with
the paper's topology mixing matrix (ring/cluster/random) under its
active-mask asynchrony, in place of an all-reduce of gradients every
step.

In the port one rank stands for one JAX device (``launch/mesh.py``):
:func:`repro_torch.launch.mesh.make_gossip_dp_mesh` lays the ranks out
as JAX's ``(node, data, model)`` (or ``(pod, node, data, model)``)
mesh, and the collectives of a mix run over the calling rank's *node
subgroup*, the ranks that share every coordinate except the node axes.
Its group ranks ascend with the node index, so group rank i is node i.

  * :func:`gossip_mix_params` — node n's params become sum_m M[n, m]
    w_m: each rank contributes its column-weighted copy ``w · M[:, n]``
    stacked over the N nodes, combined by the ``_DP_COMBINE`` schedule:
    ``"allgather"`` (and its alias ``"masked"``) all-reduces the
    (N, ...) stack and keeps the node's row; ``"psum"`` reduce-scatters
    it, so each rank receives only its own row.
  * :func:`ring_mix_params` — two neighbour exchanges over the node
    subgroup and the three-way average (the two-way one at N = 2, the
    identity at N <= 1).
  * :class:`GossipDPSchedule` — which steps mix, and the mixing matrix
    of each mix under the bernoulli or markov participation schedule.
    JAX draws with ``jax.random``; the port takes the draws as inputs
    or draws them from a ``torch.Generator`` it owns.

Without a process group (one process) the mesh has width 1 and every
mix is the identity on the params, bitwise.  :func:`ring_mix_params`
takes tensor-parallel leaves (JAX's ``specs`` from
``arch.sharding.param_pspecs``): each rank exchanges and averages only
its local shard over its node subgroup, whose members hold the same
shard of the same leaf, as JAX's ``shard_map`` body does.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.arch.sharding import PartitionSpec
from repro_torch.core.async_sched import bernoulli_active, markov_active
from repro_torch.core.topology import mixing_matrix, round_adjacency
from repro_torch.device import resolve_device
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

PyTree = Any


def node_count(mesh, node_axes: tuple[str, ...]) -> int:
    return int(math.prod(mesh.shape[a] for a in node_axes))


def _all_reduce_combine(contrib: torch.Tensor, group, idx: int) -> torch.Tensor:
    """Baseline combine: the (N, ...) contributions summed over the node
    subgroup, then this node's row; every rank holds the N-fold temp."""
    if group is not None:
        dist.all_reduce(contrib, op=dist.ReduceOp.SUM, group=group)
    return contrib[idx]


def _reduce_scatter_combine(contrib: torch.Tensor, group, idx: int) -> torch.Tensor:
    """Memory-scaled combine: a reduce-scatter along the stacked node
    dim hands each rank only its own row."""
    if group is None:
        return contrib[idx]
    out = contrib.new_empty((1,) + tuple(contrib.shape[1:]))
    dist.reduce_scatter_tensor(out, contrib, op=dist.ReduceOp.SUM, group=group)
    return out[0]


# the combine schedules, JAX's registry: "masked" aliases the allgather
# combine (secure aggregation's masks are a trainer-level wrapper); the
# sparse-only "gather" schedule has no entry, since gossip-DP nodes hold
# replicated full params and there is no row block to rotate
_DP_COMBINE = {
    "allgather": _all_reduce_combine,
    "masked": _all_reduce_combine,
    "psum": _reduce_scatter_combine,
}


def gossip_mix_params(params: PyTree, mix: torch.Tensor, mesh, node_axes: tuple[str, ...], *,
                      impl: str = "allgather") -> PyTree:
    """This node's row of ``M @ w``: sum_m M[n, m] w_m over the nodes of
    ``node_axes``, for every leaf of the node's full (replicated) params.
    ``mix`` (N, N), the same on every rank.  Each rank contributes
    ``w · M[:, n]`` (fp32, as JAX promotes it) and ``impl`` picks the
    collective (module docstring).  Raises ``ValueError`` for an unknown
    ``impl``."""
    if impl not in _DP_COMBINE:
        raise ValueError(f"impl {impl!r} not in {tuple(_DP_COMBINE)}")
    combine = _DP_COMBINE[impl]
    group, idx = mesh.node_group(node_axes), mesh.node_index(node_axes)

    def leaf(w):
        col = mix[:, idx].to(w.device)
        contrib = w[None, ...] * col.reshape((-1,) + (1,) * w.dim())
        return combine(contrib.contiguous(), group, idx)

    return tree_map(leaf, params)


def ring_mix_params(params: PyTree, mesh, node_axes: tuple[str, ...],
                    specs: PyTree | None = None) -> PyTree:
    """Ring gossip of node-replicated params: each rank receives its two
    ring neighbours' tensors over the node subgroup (node i - 1's and
    node i + 1's) and averages the three, ``(w + w_prev + w_next) / 3``;
    at N = 2 the one peer, ``(w + w_prev) / 2`` (the uniform weights of
    ``mixing_matrix(ring_adjacency(2), ...)``); at N <= 1 the params
    unchanged.

    ``specs``: one entry per leaf (None: replicated), the
    ``arch.sharding.PartitionSpec`` tree of the params' tensor-parallel
    sharding (JAX's ``specs``).  A leaf whose spec shards it is the
    rank's local shard (a plain tensor), or a DTensor, whose local shard
    is exchanged and which comes back with its placements: either way
    only the shard crosses the node subgroup, never the whole leaf.  A
    tree of another leaf count raises ``ValueError``, as JAX's does."""
    n = node_count(mesh, node_axes)
    p_leaves = tree_leaves(params)
    if specs is not None:
        s_leaves = tree_leaves(specs, is_leaf=lambda s: isinstance(s, PartitionSpec))
        if len(s_leaves) != len(p_leaves):
            raise ValueError(
                f"specs tree has {len(s_leaves)} leaves but params has "
                f"{len(p_leaves)} — a zip would silently truncate; pass "
                f"one PartitionSpec per parameter leaf")
    if n <= 1:
        return params
    group, idx = mesh.node_group(node_axes), mesh.node_index(node_axes)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)

    def exchange(w, send_to, recv_from):
        got = torch.empty_like(w)
        ops = [dist.P2POp(dist.isend, w, send_to, group=group),
               dist.P2POp(dist.irecv, got, recv_from, group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return got

    def mix(w):
        w = w.contiguous()
        w_prev = exchange(w, nxt, prv)
        if n == 2:
            return (w + w_prev) / 2.0
        w_next = exchange(w, prv, nxt)
        return (w + w_prev + w_next) / 3.0

    def leaf(w):
        if not isinstance(w, DTensor):
            return mix(w)
        return DTensor.from_local(mix(w.to_local()), w.device_mesh, w.placements,
                                  run_check=False, shape=w.shape, stride=w.stride())

    return tree_unflatten(params, [leaf(w) for w in p_leaves])


class GossipDPSchedule:
    """Host-side schedule: which steps mix, and with which matrix.

    ``schedule`` picks the participation process: ``"bernoulli"`` (iid
    per mix, the default) or ``"markov"`` (sticky busy/free, the
    previous mix's mask carried across :meth:`next_mix` calls, starting
    all-active).  Each mix reads one (N, N) score draw (the random
    topology only) and one (N,) activity draw, JAX's ``k_top`` and
    ``k_act``: :meth:`next_mix` takes them as arguments, or draws them
    from the schedule's own generator, seeded ``seed``, on ``device``
    (CUDA unless the CPU is asked for, as every entry point of the
    port)."""

    def __init__(self, topology: str, num_nodes: int, comm_batch: int = 7,
                 mix_every: int = 1, inactive_ratio: float = 0.0, seed: int = 0,
                 schedule: str = "bernoulli", p_stay_active: float = 0.9,
                 p_stay_inactive: float = 0.7, device=None):
        if schedule not in ("bernoulli", "markov"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.topology = topology
        self.num_nodes = num_nodes
        self.comm_batch = comm_batch
        self.mix_every = mix_every
        self.inactive_ratio = inactive_ratio
        self.schedule = schedule
        self.p_stay_active = p_stay_active
        self.p_stay_inactive = p_stay_inactive
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        # the chain starts all-active, as the trainer's does
        self.prev_active = torch.ones((num_nodes,), dtype=torch.float32, device=self.device)

    def should_mix(self, step: int) -> bool:
        return (step + 1) % self.mix_every == 0

    def next_mix(self, scores: torch.Tensor | None = None,
                 u_act: torch.Tensor | None = None) -> torch.Tensor:
        """The next (N, N) row-stochastic mixing matrix, from ``scores``
        (N, N) uniforms (read by the random topology) and ``u_act`` (N,)
        uniforms, each drawn from the schedule's generator when not
        given (the scores only for the random topology)."""
        n, dev = self.num_nodes, self.device
        if scores is None and self.topology == "random":
            scores = torch.rand((n, n), generator=self.generator, device=dev)
        if u_act is None:
            u_act = torch.rand((n,), generator=self.generator, device=dev)
        u_act = u_act.to(dev)
        if self.schedule == "markov":
            active = markov_active(u_act, self.prev_active, self.p_stay_active,
                                   self.p_stay_inactive)
        else:
            active = bernoulli_active(u_act, self.inactive_ratio)
        self.prev_active = active
        adj = round_adjacency(self.topology, n, None if scores is None else scores.to(dev),
                              self.comm_batch)
        return mixing_matrix(adj.to(dev), active, self.comm_batch)
