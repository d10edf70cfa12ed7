"""GluADFL, Algorithm 1 of the paper, vectorized over the federation
(the counterpart of ``repro.core.gluadfl``).

  * Line 3: per-node random init.
  * Lines 5-9: only ACTIVE nodes mix, over {self} and at most B active
    neighbours, as one gossip contraction of the whole federation's
    ``(N, D)`` parameter matrix (``core.gossip_plan``): plain PyTorch for
    ``mixer="tree"``, the hand-written CUDA kernels for
    ``mixer="kernel"`` on the card.
  * Lines 11-13: one local step per node.  By default
    (``grad_at="premix"``) the gradient is taken at the PRE-mix params
    and applied to the mixed ones; ``grad_at="mixed"`` is the usual
    DSGD variant.
  * Lines 15-16: the population model is the mean of all node models.

The federation's params live in one flat ``(N, D)`` buffer whose rows
are the nodes' parameter vectors in the JAX package's leaf order
(``utils.pytree.ParamLayout``); the optimizer's state rows sit beside
it.  A round is: activity mask -> mixing operator -> gossip -> local
step -> where-mask (inactive rows stay bitwise copies, and the int32
``step`` keeps its dtype).  Every node's loss and gradient come from
one call of :func:`mse_value_and_grad` over all rows: for the LSTM,
``LSTMModel.forward_for_grad``, backpropagation through time by
hand (``torch.bmm`` products and the fused gate kernels
``lstm_gates_fwd`` / ``lstm_gates_bwd``, each weight gradient of ``wh``
one product over the steps), which the JAX package gets from a ``vmap``
of ``value_and_grad``.  No CUDA kernel carries an autograd gradient
(their wrappers refuse inputs that require one).

Randomness enters as one :class:`~repro_torch.utils.rng.RoundDraws`
per round: drawn with a ``torch.Generator`` in production, or handed
in (the parity tests draw them with ``jax.random`` in the JAX trainer's
order and get the JAX trainer's rounds).

``train`` keeps each round's loss and eval record on the device and
syncs with the host once per ``chunk`` rounds (``engine="loop"`` is
``chunk=1``, the JAX package's per-round engine); the numbers do not
depend on ``chunk``.  The streaming eval is the built-in population val
RMSE or a caller's ``eval_fn(pop_params, val_x, val_y) -> dict`` of
float scalars (a 1-argument ``eval_fn(pop_params)`` is resolved by its
signature, as in the JAX package); it runs eagerly, so any callable
will do, and its values join the chunk's one host sync.
Each stage of a round runs inside a span (``utils.tracing.span``):
``round.draws``, ``round.mixing_operator``, ``round.gossip``,
``round.local_step``, ``round.mask``, ``round.eval``, ``chunk.sync``;
with ``gossip_impl="masked"``, ``round.secure_mask`` inside
``round.gossip``; inside ``round.local_step``, each local step's
``step.forward`` and ``step.backward`` (in :func:`mse_value_and_grad`,
so every trainer that steps through it has them, on either path) and
``step.optimizer``.  So a profile splits a round's time by stage, and
under a profiler the tracer keeps each span's host and device ms and
host syncs.  Without an active profiler a span is a
``record_function`` and one flag check: 9.1-10.3 us on the H100
machine's host, as much as ``record_function`` alone; armed, a
top-level span costs ~85-90 us there (PERF.md).

``gossip_impl="masked"`` adds pairwise-masked secure aggregation
(``core.secure_agg``): the masks come from a mask source of their own,
by default a generator seeded from ``cfg.seed`` and the mask stream's
tag, never from the round's draws, so a masked run is bitwise its
unmasked twin.
The scenario-sweep engine (:meth:`GluADFL.train_sweep`) trains the
G scenarios of a :class:`SweepGrid` (the paper's Fig-4/Fig-5 grids of
topology x inactive ratio x seed, with optional schedule, data-skew and
DP-sigma axes) as one federation of G·N rows: row ``g·N + n`` of the
flat ``(G·N, D)`` buffer is node n of scenario g, so each swept round is
one round's launches for the whole grid.  The per-scenario knobs are
tensors with a leading G; the gossip mixes each scenario's block alone
(``GossipPlan.sweep_gossip``, the tree mixer only, as in the JAX
package); the local step runs over all G·N rows at once; every
scenario's population is evaluated in one ``lstm_forward`` launch with
G groups (``apply_groups``).  Scenario g draws from its own generator,
seeded with its seed, in the order a serial :meth:`GluADFL.train` with
that seed draws, so it reproduces that serial run.

``mixer="sharded"`` splits the federation's rows over the ranks of a
``torch.distributed`` process group (``core.distributed``,
``launch.multihost``): rank r holds the contiguous block ``mesh.rows``
of ``k = N / W`` rows of the params, the optimizer state and the
staleness, and only those rows of the training windows.  Every rank
draws the round's whole :class:`RoundDraws` (and the initial params)
from the same seeded generator and keeps its rows
(:meth:`RoundDraws.rows`), so the draws are a one-process run's; every
rank builds the round's global mixing operator, mixes its rows through
the collectives of the resolved schedule, and steps its rows.  The
round's loss is an ``all_reduce`` of ``[sum(loss * act), sum(act)]``
and the population an ``all_reduce`` of the row sums over N, so every
rank's history is the same.  At W = 1 a sharded run is bitwise the tree
mixer's.  A custom loss function is not ported.

The swept-sharded engine (``train_sweep`` with ``mixer="sharded"``)
runs the grid over the ranks of a
:class:`~repro_torch.launch.mesh.SweepMesh`, one rank standing for one
device of the JAX package's ``("grid", "node")`` mesh: each rank trains
the ``(G / grid_width, N / node_width)`` block of its scenarios and
rows, gossips over its node subgroup (``core.distributed``'s grid
forms), reduces each scenario's loss and population over that
subgroup, and gathers the grid's histories and populations over its
grid subgroup once a chunk, so every rank returns all G.  One process
is the ``(1, 1)`` mesh: bitwise the tree sweep.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import FLConfig
from repro_torch.core.chunked import engine_chunk
from repro_torch.core.async_sched import bernoulli_active, markov_active, staleness_update
from repro_torch.core.distributed import (
    all_gather_grid,
    all_gather_rows,
    all_gather_scenarios,
    all_reduce_sum,
)
from repro_torch.core.gossip_plan import GossipPlan, resolve_gossip_plan
from repro_torch.core.secure_agg import (
    MaskSource,
    edge_mask_source,
    mask_generator,
    sweep_mask_sources,
)
from repro_torch.core.topology import (
    neighbor_table_from_candidates,
    random_adjacency,
    stacked_adjacency,
    static_adjacency,
)
from repro_torch.data.synth import node_skew_offsets
from repro_torch.device import resolve_device
from repro_torch.models.base import Model
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import ParamLayout, tree_index
from repro_torch.utils.rng import RoundDraws, draw_round, draw_sweep
from repro_torch.utils.tracing import span

# rounds between host syncs of the scan engine's losses and eval records
DEFAULT_CHUNK = 32


@dataclass
class FLState:
    params: torch.Tensor            # (N, D) float32, row n = node n; a sweep's (G, N, D)
    opt_state: dict                 # leaves (N, ...) or None; a sweep's (G, N, ...)
    staleness: torch.Tensor         # (N,) float32; a sweep's (G, N)
    round: int

    def reshaped(self, lead: tuple[int, ...]) -> "FLState":
        """The same state with its node rows viewed under the leading
        axes ``lead``: a sweep's (G, N) or its flat (G·N,)."""
        old = self.staleness.dim()

        def re(t):
            return None if t is None else t.reshape(*lead, *t.shape[old:])
        return FLState(re(self.params), {k: re(v) for k, v in self.opt_state.items()},
                       re(self.staleness), self.round)


@dataclass
class SweepGrid:
    """A batch of G training scenarios for :meth:`GluADFL.train_sweep`
    (the counterpart of ``repro.core.SweepGrid``).

      * ``adjacency``      (G, N, N) static adjacency per scenario (a
                           zero placeholder where the graph is drawn
                           each round), from ``topology.stacked_adjacency``;
      * ``resample``       (G,) 1 where the topology draws its graph every
                           round (``"random"``);
      * ``inactive_ratio`` (G,) the Fig-5 asynchrony ratio;
      * ``seeds``          scenario g's seed: its generator's seed, as the
                           JAX grid's ``init_keys`` hold ``PRNGKey(seed)``;
      * ``labels``         ``(topology, ratio, seed)`` for a classic grid,
                           ``(topology, ratio, schedule, skew, dp_sigma,
                           seed)`` once an optional axis is armed
                           (:meth:`label_dict` reads both).

    The optional axes are each None (unarmed) or a (G,) tensor:
    ``markov`` (1 = Markov-sticky participation), ``skew`` (node i's
    batches shifted by ``skew * node_skew_offsets(N)[i]``) and
    ``dp_sigma`` (the local-DP sigma; the noise is drawn for every
    scenario of a dp-armed grid)."""

    adjacency: torch.Tensor
    resample: torch.Tensor
    inactive_ratio: torch.Tensor
    seeds: tuple
    labels: tuple
    markov: torch.Tensor | None = None
    skew: torch.Tensor | None = None
    dp_sigma: torch.Tensor | None = None

    @property
    def size(self) -> int:
        return len(self.labels)

    def label_dict(self, g: int) -> dict:
        """Scenario ``g``'s knobs as a dict, from a 3-tuple (classic) or
        6-tuple (axis-armed) label."""
        lab = self.labels[g]
        if len(lab) == 3:
            topo, ratio, seed = lab
            sched, skew, dp = "bernoulli", 0.0, 0.0
        else:
            topo, ratio, sched, skew, dp, seed = lab
        return {"topology": topo, "inactive_ratio": ratio, "schedule": sched, "skew": skew,
                "dp_sigma": dp, "seed": seed}

    @classmethod
    def build(cls, topologies, inactive_ratios, seeds=(0,), *, num_nodes: int,
              cluster_size: int = 4, schedules=None, skews=None, dp_sigmas=None) -> "SweepGrid":
        """The cross product, topology-major, then ratio, then schedule,
        skew and dp_sigma, seed innermost (the paper's Fig-5 layout:
        ``build(("ring", "cluster", "random"), (0.0, 0.3, 0.5, 0.7,
        0.9), num_nodes=N)``).  An optional axis left None stays out of
        the product and the labels stay 3-tuples unless one is armed."""
        sched_ax = tuple(str(v) for v in schedules) if schedules else None
        if sched_ax is not None:
            bad = [v for v in sched_ax if v not in ("bernoulli", "markov")]
            if bad:
                raise ValueError(f"unknown schedule(s) {bad!r}")
        skew_ax = tuple(float(v) for v in skews) if skews else None
        dp_ax = tuple(float(v) for v in dp_sigmas) if dp_sigmas else None
        armed = any(ax is not None for ax in (sched_ax, skew_ax, dp_ax))
        scenarios = [
            (str(t), float(r), sc, sk, dp, int(seed))
            for t in topologies
            for r in inactive_ratios
            for sc in (sched_ax or ("bernoulli",))
            for sk in (skew_ax or (0.0,))
            for dp in (dp_ax or (0.0,))
            for seed in seeds
        ]
        if not scenarios:
            raise ValueError("empty sweep grid")
        adjacency, resample = stacked_adjacency([sc[0] for sc in scenarios], num_nodes,
                                                cluster_size)

        def column(i, fn=float):
            return torch.tensor([fn(sc[i]) for sc in scenarios], dtype=torch.float32)
        return cls(
            adjacency=adjacency,
            resample=resample,
            inactive_ratio=column(1),
            seeds=tuple(sc[5] for sc in scenarios),
            labels=tuple(scenarios if armed else [(t, r, seed) for t, r, *_, seed in scenarios]),
            markov=None if sched_ax is None else column(2, lambda v: v == "markov"),
            skew=None if skew_ax is None else column(3),
            dp_sigma=None if dp_ax is None else column(4),
        )


@dataclass
class _Scenarios:
    """A grid's per-scenario knobs on the trainer's device, as the swept
    round reads them (None: that axis is off for every scenario)."""

    adjacency: torch.Tensor          # (G, N, N)
    resample: torch.Tensor           # (G,)
    inactive_ratio: torch.Tensor     # (G,)
    markov: torch.Tensor | None      # (G,)
    sigma: torch.Tensor | None       # (G·N, 1) DP sigma of each row
    shift: torch.Tensor | None       # (G·N,) data-skew shift of each row
    mask_sources: Sequence[MaskSource] | None
    plan: GossipPlan                 # the trainer's, or its plan on the sweep mesh
    mesh: object = None              # the SweepMesh of a swept-sharded run

    @property
    def node(self):
        """The node subgroup's mesh (None off the sharded mixer)."""
        return None if self.mesh is None else self.mesh.node


@dataclass
class FedTensors:
    """The federation's padded training data on the trainer's device."""

    x: torch.Tensor        # (N, M, L) float32
    y: torch.Tensor        # (N, M)
    counts: torch.Tensor   # (N,) int64

    @classmethod
    def of(cls, x, y, counts, device) -> "FedTensors":
        """The padded arrays as tensors on ``device``."""
        return cls(
            x=torch.as_tensor(np.asarray(x, np.float32)).to(device),
            y=torch.as_tensor(np.asarray(y, np.float32)).to(device),
            counts=torch.as_tensor(np.asarray(counts, np.int64)).to(device),
        )

    def batches(self, idx: torch.Tensor):
        """Node n's windows ``idx[n]`` (N, B): ``(bx (N, B, L), by (N, B))``."""
        bx = torch.gather(self.x, 1, idx[:, :, None].expand(-1, -1, self.x.shape[2]))
        return bx, torch.gather(self.y, 1, idx)


def _eval_scalar(key, value) -> torch.Tensor:
    """One streaming-eval value as a 0-d floating tensor (a Python float
    becomes a float64 CPU tensor); anything else raises the JAX
    package's ``TypeError``."""
    if isinstance(value, (np.ndarray, np.generic)):
        value = torch.from_numpy(np.asarray(value))
    if isinstance(value, float):
        return torch.tensor(value, dtype=torch.float64)
    if isinstance(value, torch.Tensor) and value.is_floating_point() and value.dim() == 0:
        return value
    if isinstance(value, torch.Tensor):
        kind = f"{str(value.dtype).removeprefix('torch.')}{tuple(value.shape)}"
    else:
        kind = f"{type(value).__name__}()"
    raise TypeError(
        f"streaming eval_fn output {key!r} must be a floating SCALAR (NaN is the "
        f"off-boundary sentinel and the history records floats), got {kind}")


def eval_record(out) -> dict[str, torch.Tensor]:
    """Check one ``eval_fn`` result, a dict of float scalars, and return
    its values as 0-d tensors (left on their device until the chunk's
    sync)."""
    if not isinstance(out, dict):
        raise TypeError(f"streaming eval_fn must return a dict of float scalars, "
                        f"got {type(out).__name__}")
    return {k: _eval_scalar(k, v) for k, v in out.items()}


def read_host(parts: Sequence[torch.Tensor]) -> list[list[float]]:
    """A chunk's one host sync: each of ``parts`` (tensors of any shape)
    as a flat list of Python floats.  The parts on a device go to the
    host in one copy, as float64 (exact for the float32 losses); those
    already on the CPU are read as they are."""
    out: list = [None] * len(parts)
    on_device = [i for i, t in enumerate(parts) if t.device.type != "cpu"]
    if on_device:
        flat = torch.cat([parts[i].reshape(-1).to(torch.float64) for i in on_device]).cpu().tolist()
        at = 0
        for i in on_device:
            out[i], at = flat[at:at + parts[i].numel()], at + parts[i].numel()
    for i, t in enumerate(parts):
        if out[i] is None:
            out[i] = t.reshape(-1).to(torch.float64).tolist()
    return out


def mse_value_and_grad(model: Model, layout: ParamLayout, params: torch.Tensor,
                       bx: torch.Tensor, by: torch.Tensor):
    """Per-row MSE losses (N,) and their gradients (N, D) at the flat
    ``params`` (N, D), row n's batch ``bx[n]`` (Bt, L) against
    ``by[n]``.  A model with a hand-written ``forward_for_grad`` (the
    LSTM) computes them itself: its forward runs inside
    ``step.forward`` and the call it returns for the gradient inside
    ``step.backward``.  Any other (N-BEATS, N-HiTS, the linear baseline)
    takes one autograd backward of the summed losses of
    ``model.apply_nodes``: rows share no parameters, so that gives every
    row its own gradient (the JAX package takes a ``vmap`` of
    ``value_and_grad``).  The trainer's local step, FedAvg, the pooled
    supervised baseline and the cold-start fine-tune
    (``core.personalize``) all use it."""
    if model.forward_for_grad is not None:
        with span("step.forward"):
            losses, backward = model.forward_for_grad(layout, params, bx, by)
        with span("step.backward"):
            return losses, backward()
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        with span("step.forward"):
            pred = model.apply_nodes(layout.views(p), bx)
            losses = torch.mean(torch.square(pred - by), dim=1)
            total = losses.sum()
        with span("step.backward"):
            (grads,) = torch.autograd.grad(total, p)
    return losses.detach(), grads


class GluADFL:
    """Asynchronous decentralized FL trainer (the paper's contribution).

    ``device`` defaults to CUDA and raises without a GPU; pass ``"cpu"``
    to run on the CPU, where the kernel mixer runs the kernels' plain
    twins."""

    def __init__(
        self,
        model: Model,
        optimizer: Optimizer,
        cfg: FLConfig,
        *,
        grad_at: str = "premix",
        mixer: str | None = None,
        gossip_impl: str = "allgather",
        gossip_repr: str = "dense",
        dp_noise_sigma: float = 0.0,
        mask_source: MaskSource | None = None,
        mesh=None,
        device=None,
    ):
        if grad_at not in ("premix", "mixed"):
            raise ValueError(f"grad_at must be 'premix' or 'mixed', got {grad_at!r}")
        if cfg.schedule not in ("bernoulli", "markov"):
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        self.device = resolve_device(device)
        self.model = model
        self.optimizer = optimizer
        self.cfg = cfg
        self.grad_at = grad_at
        self.dp_noise_sigma = float(dp_noise_sigma)
        self.plan = resolve_gossip_plan(
            mixer=mixer, gossip_impl=gossip_impl, gossip_repr=gossip_repr,
            num_nodes=cfg.num_nodes,
            comm_batch=cfg.comm_batch, topology=cfg.topology,
            cluster_size=cfg.cluster_size, mesh=mesh, device=self.device,
        )
        # the sharded mixer's FederationMesh (this rank's rows) or the
        # SweepMesh it was given, else None
        self.mesh = self.plan.mesh
        self._mesh_given = mesh is not None
        self._sweep_plans: dict = {}  # G -> the sharded plan on its sweep mesh
        self.layout = ParamLayout.of(model.init(torch.Generator().manual_seed(0)))
        if mask_source is not None and not self.plan.masked:
            raise ValueError("mask_source is for gossip_impl='masked'")
        # (idx, wgt) -> (N, P, D) masks; None unless masked
        self.mask_source = mask_source
        if self.plan.masked and mask_source is None:
            self.mask_source = edge_mask_source(mask_generator(cfg.seed, self.device),
                                                self.layout.dim)
        n = cfg.num_nodes
        adj = static_adjacency(cfg.topology, n, cfg.cluster_size)
        self._static_adj = None if adj is None else adj.to(self.device)
        self._shift = None
        if cfg.data_skew != 0.0:
            offsets = torch.from_numpy(node_skew_offsets(n)).to(self.device)
            self._shift = cfg.data_skew * offsets

    # ------------------------------------------------------------------
    def state_from_params(self, stacked: dict) -> FLState:
        """A fresh federation state from stacked per-node params (leaves
        ``(N, *shape)``, or a sweep's ``(G, N, *shape)``; tensors or
        arrays): optimizer state at zero, staleness 0, round 0, with the
        params' leading axes."""
        leaves = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
                  for k, v in stacked.items()}
        first, shape = leaves[self.layout.names[0]], self.layout.shapes[0]
        lead = tuple(first.shape[: first.dim() - len(shape)])
        params = self.layout.flatten(
            {k: leaves[k].reshape(-1, *s) for k, s in zip(self.layout.names, self.layout.shapes)}
        ).to(self.device)
        n = self.cfg.num_nodes
        if lead[-1:] != (n,) or len(lead) > 2:
            raise ValueError(f"params must stack {n} nodes of {self.layout.dim} values, "
                             f"got leading axes {lead} and {tuple(params.shape)} in all")
        return self._fresh_state(params).reshaped(lead)

    def _fresh_state(self, params: torch.Tensor) -> FLState:
        return FLState(
            params=params,
            opt_state=self.optimizer.init(params),
            staleness=torch.zeros(params.shape[0], device=self.device),
            round=0,
        )

    def _draw_params(self, generator: torch.Generator) -> torch.Tensor:
        """Every node's params from ``generator``, node 0 first, as one
        (N, D) buffer."""
        rows = [self.model.init(generator, device=self.device) for _ in range(self.cfg.num_nodes)]
        return self.layout.flatten({k: torch.stack([r[k] for r in rows]) for k in rows[0]})

    def init(self, generator: torch.Generator) -> FLState:
        """Draw every node's params from ``generator``, node 0 first (the
        JAX package's scales; not its numbers)."""
        return self._fresh_state(self._draw_params(generator))

    def shard_state(self, state: FLState) -> FLState:
        """This process's rows of a whole-federation state: the rank's
        block on the sharded mixer, every row otherwise."""
        rows = self.plan.rows

        def cut(t):
            return None if t is None else t[rows]
        return FLState(cut(state.params), {k: cut(v) for k, v in state.opt_state.items()},
                       cut(state.staleness), state.round)

    def init_sharded(self, generator: torch.Generator) -> FLState:
        """:meth:`init`'s state, this process's rows of it: every rank
        draws the whole federation from the same generator, so its rows
        are a one-process run's."""
        return self.shard_state(self.init(generator))

    def to_device(self, x, y, counts, mesh=None) -> FedTensors:
        """The federation's padded arrays as tensors on the device: on
        the sharded mixer (``mesh``, default the trainer's) this rank's
        rows of the windows, with the counts whole (every rank draws the
        whole round); on a sweep mesh its node subgroup's rows."""
        mesh = self.mesh if mesh is None else mesh
        if mesh is None:
            return FedTensors.of(x, y, counts, self.device)
        from repro_torch.launch.multihost import place_federation

        node = mesh.node if mesh.axis_names == ("grid", "node") else mesh
        x, y, counts, _ = place_federation(node, x, y, counts, device=self.device)
        return FedTensors(x, y, counts)

    def draw(self, generator: torch.Generator, data: FedTensors, batch_size: int) -> RoundDraws:
        """One round's draws from ``generator`` (on the trainer's device)."""
        return draw_round(
            generator, data.counts, local_steps=self.cfg.local_steps, batch_size=batch_size,
            random_topology=self._static_adj is None and self.plan.neighbor_cand is None,
            dp_dim=self.layout.dim if self.dp_noise_sigma > 0.0 else 0,
        )

    # ------------------------------------------------------------------
    def _local_step(self, premix, mixed, opt_state, data: FedTensors, batch_idx, shift=None):
        """``local_steps`` optimizer steps for every row: the first
        gradient at the pre-mix (or mixed) params, applied to the mixed
        ones; later steps are ordinary steps.  Row r trains on node
        ``r % N``'s data (a sweep's G·N rows share the N nodes'),
        shifted by ``shift[r]`` when given.  Returns the new params,
        optimizer state and each row's mean loss."""
        p_grad = premix if self.grad_at == "premix" else mixed
        p_apply, state = mixed, opt_state
        n, m, seq = data.x.shape
        # each row's node's first window in the flat (N·M, L) windows
        base = (torch.arange(batch_idx.shape[0], device=batch_idx.device) % n * m)[:, None]
        losses = []
        for s in range(batch_idx.shape[1]):
            flat = base + batch_idx[:, s]
            bx = data.x.view(-1, seq)[flat]
            by = data.y.view(-1)[flat]
            if shift is not None:
                bx = bx + shift[:, None, None]
                by = by + shift[:, None]
            loss, grads = mse_value_and_grad(self.model, self.layout, p_grad, bx, by)
            with span("step.optimizer"):
                p_apply, state = self.optimizer.update(grads, state, p_apply)
            p_grad = p_apply
            losses.append(loss)
        return p_apply, state, torch.stack(losses).mean(dim=0)

    def round(self, state: FLState, data: FedTensors, draws: RoundDraws):
        """One FL round: returns ``(new_state, loss)``, the loss the
        active-weighted mean of the nodes' losses, as a 0-d tensor on the
        device (no host sync).  ``draws`` are the whole federation's; on
        the sharded mixer ``state`` and ``data`` hold this rank's rows."""
        rows = self.plan.rows
        with span("round.mixing_operator"):
            active, operand, adj = self.mixing_operator(state, draws)
        mine = draws.rows(rows.start, rows.stop)
        act = active[rows]
        premix = state.params
        noise = None
        if self.dp_noise_sigma > 0.0:
            if draws.dp_noise is None:
                raise ValueError("dp_noise_sigma > 0 needs RoundDraws.dp_noise")
            noise = self.dp_noise_sigma * mine.dp_noise
        with span("round.gossip"):
            mask_ctx = (self.mask_source, adj) if self.plan.masked else None
            mixed = self.plan.gossip(premix, operand, active, noise, mask_ctx)
        with span("round.local_step"):
            new_params, new_opt, losses = self._local_step(
                premix, mixed, state.opt_state, data, mine.batch_idx,
                None if self._shift is None else self._shift[rows])

        # inactive nodes keep their params and optimizer rows: a
        # where-select, so they are bitwise copies and int32 leaves stay int32
        def keep_inactive(new, old):
            if new is None:
                return None
            return torch.where(act.reshape((-1,) + (1,) * (new.dim() - 1)) > 0, new, old)

        with span("round.mask"):
            params = keep_inactive(new_params, premix)
            opt_state = {k: keep_inactive(v, state.opt_state[k]) for k, v in new_opt.items()}
            num, den = torch.sum(losses * act), torch.sum(act)
            if self.mesh is not None:
                num, den = all_reduce_sum(torch.stack([num, den]), self.mesh)
            loss = num / torch.clamp_min(den, 1.0)
            staleness = staleness_update(state.staleness, act)
        return FLState(params, opt_state, staleness, state.round + 1), loss

    def mixing_operator(self, state: FLState, draws: RoundDraws):
        """The round's active mask, mixing operator (dense matrix or
        neighbor table) and adjacency (None when a static topology's
        table is built from its candidates)."""
        cfg = self.cfg
        n = cfg.num_nodes
        if cfg.schedule == "markov":
            # a node with staleness 0 took part in the last round
            staleness = state.staleness if self.mesh is None else all_gather_rows(
                state.staleness, self.mesh)
            prev_active = (staleness == 0).to(torch.float32)
            active = markov_active(draws.u_act, prev_active, cfg.p_stay_active,
                                   cfg.p_stay_inactive)
        else:
            active = bernoulli_active(draws.u_act, cfg.inactive_ratio)
        if self.plan.neighbor_cand is not None:
            cand_idx, cand_valid = self.plan.neighbor_cand
            operand = neighbor_table_from_candidates(cand_idx, cand_valid, active, cfg.comm_batch)
            return active, operand, None
        adj = self._static_adj
        if adj is None:
            adj = random_adjacency(draws.scores, min(cfg.comm_batch, n - 1))
        return active, self.plan.build_repr(adj, active), adj

    # ------------------------------------------------------------------
    def population(self, state: FLState) -> dict[str, torch.Tensor]:
        """Algorithm 1 lines 15-16: the mean of all node models, as a
        param dict (views into one new (D,) vector); over a process
        group, an ``all_reduce`` of the ranks' row sums over N, the same
        on every rank."""
        if self.mesh is None or self.mesh.group is None:
            return self.layout.row(state.params.mean(dim=0))
        total = all_reduce_sum(state.params.sum(dim=0), self.mesh)
        return self.layout.row(total / self.cfg.num_nodes)

    def _default_eval_metrics(self, pop_params, val_x, val_y) -> dict[str, torch.Tensor]:
        """The built-in streaming eval: the population's validation RMSE
        (0-d, on the device); on CUDA the forward is the
        ``lstm_forward`` kernel."""
        with torch.no_grad():
            pred = self.model.apply(pop_params, val_x)
            return {"val_rmse": torch.sqrt(torch.mean(torch.square(pred - val_y)))}

    def resolve_eval_fn(self, eval_fn: Callable | None) -> Callable:
        """``eval_fn`` as ``f(pop_params, val_x, val_y) -> dict``: None is
        the built-in val RMSE, and a 1-argument ``f(pop_params)`` is
        wrapped (the JAX package's ``_resolve_eval_fn``)."""
        if eval_fn is None:
            return self._default_eval_metrics
        try:
            n_params = len(inspect.signature(eval_fn).parameters)
        except (TypeError, ValueError):
            n_params = 3
        if n_params != 1:
            return eval_fn
        return lambda pop, vx, vy: eval_fn(pop)

    def train(
        self,
        generator: torch.Generator | None,
        x,
        y,
        counts,
        *,
        batch_size: int = 64,
        rounds: int | None = None,
        eval_every: int = 0,
        eval_fn: Callable | None = None,
        val_data: tuple | None = None,
        chunk: int | None = None,
        engine: str = "scan",
        state: FLState | None = None,
        draws: Iterable[RoundDraws] | None = None,
    ):
        """Run T rounds; returns ``(population_params, history, state)``.

        ``generator`` (on the trainer's device) draws the initial params
        unless ``state`` is given, and each round's draws unless
        ``draws`` yields them.  The eval is armed by ``eval_every > 0``
        and ``eval_fn`` or ``val_data``: ``eval_fn(pop_params, val_x,
        val_y)`` (or ``eval_fn(pop_params)``; default: the population's
        val RMSE as ``val_rmse``) runs after every round t with ``(t + 1)
        % eval_every == 0`` on the val tensors (None without
        ``val_data``), and its dict joins that round's history record.
        ``engine="scan"`` syncs with the host once per ``chunk`` rounds
        (default :data:`DEFAULT_CHUNK`), ``"loop"`` once a round; the
        history does not depend on either.

        Over several processes (``launch.multihost.initialize``) every
        rank calls this with the same arguments: the sharded mixer is
        required, ``engine="loop"`` is refused as in the JAX package,
        ``state`` holds the rank's rows (:meth:`shard_state`) and every
        rank returns the same population and history."""
        if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
            if engine == "loop":
                raise NotImplementedError("engine='loop' is the single-process debug "
                                          "fallback; multi-process runs use the scan engine")
            self.plan.require_multihost()
        if self.mesh is not None and self.mesh.axis_names != ("node",):
            raise ValueError("a sweep mesh lays out train_sweep's scenarios; train() runs on "
                             "the federation mesh (launch.mesh.make_federation_mesh)")
        chunk = engine_chunk(engine, chunk, 0)[0]
        rounds = self.cfg.rounds if rounds is None else rounds
        data = self.to_device(x, y, counts)
        if state is None:
            state = self.init_sharded(generator)
        if state.params.shape[0] != data.x.shape[0]:
            raise ValueError(f"state holds {state.params.shape[0]} rows, this process trains "
                             f"{data.x.shape[0]} (pass shard_state(state) on the sharded mixer)")
        stream: Iterator[RoundDraws] | None = None if draws is None else iter(draws)
        val_x, val_y = self._val_tensors(val_data)
        do_eval = bool(eval_every) and (eval_fn is not None or val_data is not None)
        resolved = self.resolve_eval_fn(eval_fn) if do_eval else None
        chunk = max(1, min(chunk or DEFAULT_CHUNK, rounds))
        history: list[dict] = []
        t = 0
        while t < rounds:
            c = min(chunk, rounds - t)
            losses, evals = [], {}
            for i in range(c):
                with span("round.draws"):
                    rd = next(stream) if stream is not None else self.draw(generator, data, batch_size)
                state, loss = self.round(state, data, rd)
                losses.append(loss)
                if do_eval and (t + i + 1) % eval_every == 0:
                    with span("round.eval"):
                        evals[i] = eval_record(resolved(self.population(state), val_x, val_y))
            # one host sync per chunk: losses and eval records together
            with span("chunk.sync"):
                host = iter(read_host([torch.stack(losses)]
                                      + [v for rec in evals.values() for v in rec.values()]))
            history += [{"round": t + i, "loss": v} for i, v in enumerate(next(host))]
            for i, rec in evals.items():
                history[t + i].update({k: next(host)[0] for k in rec})
            t += c
        return self.population(state), history, state

    def _val_tensors(self, val_data):
        """``val_data`` as float32 tensors on the device, or (None, None)."""
        if val_data is None:
            return None, None
        return tuple(torch.as_tensor(np.asarray(v, np.float32)).to(self.device) for v in val_data)

    # ------------------------------------------------------------------
    def _scenarios(self, grid: SweepGrid, plan: GossipPlan, mesh=None) -> _Scenarios:
        """The knobs of this rank's scenarios on the device (every
        scenario off the sharded mixer), each row's for its rows
        ``plan.rows``.  Unarmed axes fall back to the trainer's own: its
        DP sigma and its config's data skew for every scenario, as in
        the JAX package."""
        dev, n = self.device, self.cfg.num_nodes
        scen = slice(None) if mesh is None else mesh.scenarios(grid.size)
        rows = plan.rows
        k = len(range(n)[rows])
        sigma = grid.dp_sigma
        if sigma is None and self.dp_noise_sigma > 0.0:
            sigma = torch.full((grid.size,), self.dp_noise_sigma)
        skew = grid.skew
        if skew is None and self.cfg.data_skew != 0.0:
            skew = torch.full((grid.size,), self.cfg.data_skew)
        shift = None
        if skew is not None:
            offsets = torch.from_numpy(node_skew_offsets(n))[rows]
            shift = (skew[scen, None] * offsets[None, :]).reshape(-1).to(dev)
        sources = None
        if plan.masked:
            sources = sweep_mask_sources(grid.seeds[scen], self.layout.dim, dev)
        return _Scenarios(
            adjacency=grid.adjacency[scen].to(dev), resample=grid.resample[scen].to(dev),
            inactive_ratio=grid.inactive_ratio[scen].to(dev),
            markov=None if grid.markov is None else grid.markov[scen].to(dev),
            sigma=None if sigma is None else sigma[scen].repeat_interleave(k)[:, None].to(dev),
            shift=shift, mask_sources=sources, plan=plan, mesh=mesh,
        )

    def sweep_round(self, state: FLState, data: FedTensors, draws: RoundDraws,
                    sc: _Scenarios):
        """One round of every scenario: ``state`` holds the flat (G·k, ...)
        rows (k = N, or a rank's N / node_width rows of each of its G
        scenarios on the sharded mixer), ``draws`` the G scenarios'
        whole draws stacked (``draw_sweep``), of which the rank keeps
        its rows.  Returns ``(new_state, losses)``, each scenario's
        active-weighted mean loss as a (G,) tensor on the device."""
        cfg, plan, node = self.cfg, sc.plan, sc.node
        g, n = draws.u_act.shape
        rows = plan.rows
        k = data.x.shape[0]
        with span("round.mixing_operator"):
            active = bernoulli_active(draws.u_act, sc.inactive_ratio)
            if sc.markov is not None:
                # both schedules read the same uniforms: arming the axis moves no draw
                staleness = state.staleness.view(g, k)
                if node is not None:
                    staleness = all_gather_grid(staleness, node)
                prev_active = (staleness == 0).to(torch.float32)
                sticky = markov_active(draws.u_act, prev_active, cfg.p_stay_active,
                                       cfg.p_stay_inactive)
                active = torch.where(sc.markov[:, None] > 0, sticky, active)
            adj = sc.adjacency
            if draws.scores is not None:
                drawn = random_adjacency(draws.scores, min(cfg.comm_batch, n - 1))
                adj = torch.where(sc.resample[:, None, None] > 0, drawn, adj)
            operand = plan.build_repr(adj, active)
        premix = state.params
        act = active[:, rows]
        noise = None
        if sc.sigma is not None:
            if draws.dp_noise is None:
                raise ValueError("a DP sweep needs RoundDraws.dp_noise")
            noise = sc.sigma * draws.dp_noise[:, rows].reshape(g * k, -1)
        with span("round.gossip"):
            mask_ctx = None if sc.mask_sources is None else (sc.mask_sources, adj)
            mixed = plan.sweep_gossip(premix, operand, active, noise, mask_ctx)
        with span("round.local_step"):
            new_params, new_opt, losses = self._local_step(
                premix, mixed, state.opt_state, data,
                draws.batch_idx[:, rows].reshape(g * k, *draws.batch_idx.shape[2:]), sc.shift)
        flat_act = act.reshape(-1)

        def keep_inactive(new, old):
            if new is None:
                return None
            return torch.where(flat_act.reshape((g * k,) + (1,) * (new.dim() - 1)) > 0, new, old)

        with span("round.mask"):
            params = keep_inactive(new_params, premix)
            opt_state = {key: keep_inactive(v, state.opt_state[key]) for key, v in new_opt.items()}
            num, den = torch.sum(losses.view(g, k) * act, dim=1), torch.sum(act, dim=1)
            if node is not None:
                num, den = all_reduce_sum(torch.stack([num, den]), node)
            loss = num / torch.clamp_min(den, 1.0)
            staleness = staleness_update(state.staleness, flat_act)
        return FLState(params, opt_state, staleness, state.round + 1), loss

    def populations(self, state: FLState, g: int, node=None) -> torch.Tensor:
        """Each scenario's population model (the mean of its N rows of the
        flat (G·N, D) params) as a (G, D) tensor; on a node subgroup
        ``node`` (a rank's (G·k, D) rows), an ``all_reduce`` of the row
        sums over N."""
        rows = state.params.view(g, state.params.shape[0] // g, -1)
        if node is None or node.group is None:
            return rows.mean(dim=1)
        return all_reduce_sum(rows.sum(dim=1), node) / self.cfg.num_nodes

    def sweep_val_rmse(self, pops: torch.Tensor, val_x: torch.Tensor,
                       val_y: torch.Tensor) -> torch.Tensor:
        """Each population's val RMSE, (G,) on the device: one forward of
        the G models over the shared windows (on CUDA one
        ``lstm_forward`` launch with G groups)."""
        with torch.no_grad():
            pred = self.model.apply_groups(self.layout.views(pops), val_x)
            return torch.sqrt(torch.mean(torch.square(pred - val_y), dim=1))

    def _sweep_eval(self, state: FLState, g: int, eval_fn: Callable | None, val_x,
                    val_y, node=None) -> dict[str, torch.Tensor]:
        """One eval round of every scenario: each key's (G,) values, from
        the resolved ``eval_fn`` once a scenario, or (None) the built-in
        val RMSE of all G populations in one forward."""
        pops = self.populations(state, g, node)
        if eval_fn is None:
            return {"val_rmse": self.sweep_val_rmse(pops, val_x, val_y)}
        views = self.layout.views(pops)
        recs = [eval_record(eval_fn(tree_index(views, s), val_x, val_y)) for s in range(g)]
        return {k: torch.stack([rec[k].to(recs[0][k].device, torch.float64) for rec in recs])
                for k in recs[0]}

    def train_sweep(
        self,
        x,
        y,
        counts,
        *,
        grid: SweepGrid,
        generators: Sequence[torch.Generator] | None = None,
        batch_size: int = 64,
        rounds: int | None = None,
        chunk: int | None = None,
        eval_every: int = 0,
        eval_fn: Callable | None = None,
        val_data: tuple | None = None,
        states: FLState | None = None,
        draws: Iterable[RoundDraws] | None = None,
    ):
        """Train every scenario of ``grid`` as one batched federation;
        returns ``(populations, histories, states)`` in the JAX
        package's layout: the populations as a param dict of (G, ...)
        leaves (``utils.pytree.tree_index`` picks one), G history lists
        of :meth:`train`'s records, and the final state with (G, N, ...)
        leaves.

        Scenario g draws from ``generators[g]`` (default: a generator on
        the device seeded ``grid.seeds[g]``): its initial params unless
        ``states`` (leaves (G, N, ...), e.g. from
        :meth:`state_from_params`) is given, then its rounds unless
        ``draws`` yields them stacked, one :class:`RoundDraws` with a
        leading G a round.  So scenario g equals :meth:`train` of its
        config from a generator seeded ``grid.seeds[g]``.  The eval is
        :meth:`train`'s, per scenario: a caller's ``eval_fn`` is called
        once a scenario on its population (``tree_index(pops, g)``),
        while the built-in val RMSE evaluates all G populations in one
        forward (:meth:`sweep_val_rmse`).  The host syncs once per
        ``chunk`` rounds for the whole grid.  The kernel mixer is
        refused (``GossipPlan.require_sweep``).

        With ``mixer="sharded"`` the grid runs on a sweep mesh (the one
        the trainer was given, else :func:`launch.mesh.make_sweep_mesh`
        of (G, N) over the default group), each rank standing for one
        device of the JAX package's ``("grid", "node")`` mesh: every
        rank calls this with the same arguments, ``generators``,
        ``states`` and ``draws`` cover the whole grid, and each rank
        keeps its scenarios' block of them and its rows
        (``mesh.scenarios(G)``, ``mesh.rows``), draws what it draws
        from its scenarios' generators, and evaluates its scenarios'
        populations in one forward.  Every rank returns all G
        populations and histories; ``states`` is the rank's
        (G / grid_width, N / node_width, ...) block.  Over more than one
        rank, a tree sweep is refused: it batches scenarios on one
        process (the JAX package's ``process_count() > 1`` refusal)."""
        grouped = dist.is_available() and dist.is_initialized()
        if grouped and dist.get_world_size() > 1 and not self.plan.caps.uses_mesh:
            raise NotImplementedError(
                "train_sweep batches the tree mixer's scenarios on one process; over several "
                "ranks a sweep needs mixer='sharded' (the swept-sharded engine)")
        self.plan.require_sweep()
        n = self.cfg.num_nodes
        if grid.adjacency.shape[-1] != n:
            raise ValueError(f"grid built for N={grid.adjacency.shape[-1]} nodes but "
                             f"cfg.num_nodes={n}")
        plan, mesh = self.plan, None
        if plan.caps.uses_mesh:
            plan = self._sweep_plan(grid.size)
            mesh = plan.mesh
        scen = slice(None) if mesh is None else mesh.scenarios(grid.size)
        g = len(range(grid.size)[scen])
        rows = plan.rows
        rounds = self.cfg.rounds if rounds is None else rounds
        data = self.to_device(x, y, counts, mesh)
        k = data.x.shape[0]
        if generators is None and (states is None or draws is None):
            generators = [torch.Generator(device=self.device).manual_seed(seed)
                          for seed in grid.seeds[scen]]
        elif generators is not None:
            generators = list(generators)[scen]
        if states is None:
            state = self._fresh_state(torch.cat([self._draw_params(gen)[rows]
                                                 for gen in generators]))
        else:
            def cut(t):
                return None if t is None else t[scen][:, rows]
            state = FLState(cut(states.params), {key: cut(v) for key, v in states.opt_state.items()},
                            cut(states.staleness), states.round).reshaped((g * k,))
        sc = self._scenarios(grid, plan, mesh)
        stream: Iterator[RoundDraws] | None = None if draws is None else iter(draws)
        resample = [bool(v) for v in grid.resample[scen].tolist()]
        dp_dim = self.layout.dim if sc.sigma is not None else 0
        val_x, val_y = self._val_tensors(val_data)
        do_eval = bool(eval_every) and (eval_fn is not None or val_data is not None)
        resolved = None if eval_fn is None else self.resolve_eval_fn(eval_fn)
        chunk = max(1, min(chunk or DEFAULT_CHUNK, rounds))
        histories: list[list[dict]] = [[] for _ in range(grid.size)]
        t = 0
        while t < rounds:
            c = min(chunk, rounds - t)
            losses, evals = [], {}
            for i in range(c):
                with span("round.draws"):
                    if stream is not None:
                        # a whole-grid round; its leading axis is the scenarios'
                        rd = next(stream).rows(scen.start, scen.stop)
                    else:
                        rd = draw_sweep(generators, data.counts, local_steps=self.cfg.local_steps,
                                        batch_size=batch_size, resample=resample, dp_dim=dp_dim)
                state, loss = self.sweep_round(state, data, rd, sc)
                losses.append(loss)
                if do_eval and (t + i + 1) % eval_every == 0:
                    with span("round.eval"):
                        evals[i] = self._sweep_eval(state, g, resolved, val_x, val_y, sc.node)
            # one host sync per chunk for the whole grid: this rank's
            # scenarios' losses and eval values as one (G, ...) block,
            # gathered over the grid subgroup
            with span("chunk.sync"):
                block = torch.cat([torch.stack(losses, dim=1).to(torch.float64)]
                                  + [v.to(self.device, torch.float64)[:, None]
                                     for rec in evals.values() for v in rec.values()], dim=1)
                if mesh is not None:
                    block = all_gather_scenarios(block, mesh)
                host = read_host([block])[0]
            width = block.shape[1]
            for s_, hist in enumerate(histories):
                row = iter(host[s_ * width:(s_ + 1) * width])
                hist += [{"round": t + i, "loss": next(row)} for i in range(c)]
                for i, rec in evals.items():
                    hist[t + i].update({key: next(row) for key in rec})
            t += c
        pops = self.populations(state, g, sc.node)
        if mesh is not None:
            pops = all_gather_scenarios(pops, mesh)
        return self.layout.views(pops), histories, state.reshaped((g, k))

    def _sweep_plan(self, num_scenarios: int) -> GossipPlan:
        """The sharded plan of a G-scenario sweep, on the sweep mesh the
        trainer was given or else on ``make_sweep_mesh(G, N)`` of the
        default group (built once per G; every rank builds it in the
        same order)."""
        n = self.cfg.num_nodes
        if self._mesh_given:
            mesh = self.mesh
            if mesh.axis_names != ("grid", "node"):
                raise ValueError(f"swept-sharded training needs a 2-D ('grid', 'node') mesh "
                                 f"(launch.mesh.make_sweep_mesh), got axes {mesh.axis_names}")
            if num_scenarios % mesh.grid_width or n % mesh.node_width:
                raise ValueError(f"sweep mesh {mesh.shape} does not divide the grid: "
                                 f"G={num_scenarios}, N={n}")
            return self.plan
        if num_scenarios not in self._sweep_plans:
            from repro_torch.launch.mesh import make_sweep_mesh

            p = self.plan
            self._sweep_plans[num_scenarios] = resolve_gossip_plan(
                mixer=p.mixer, gossip_impl=p.gossip_impl, gossip_repr=p.gossip_repr,
                num_nodes=n, comm_batch=p.comm_batch, topology=self.cfg.topology,
                cluster_size=self.cfg.cluster_size,
                mesh=make_sweep_mesh(num_scenarios, n, device=self.device), device=self.device)
        return self._sweep_plans[num_scenarios]
