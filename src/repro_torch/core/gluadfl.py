"""GluADFL, Algorithm 1 of the paper, vectorized over the federation
(the single-process counterpart of ``repro.core.gluadfl``).

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
``step`` keeps its dtype).  Each node's gradient comes from one
``backward`` of the sum of the nodes' losses through
``LSTMModel.apply_nodes``, in plain PyTorch: nodes share no parameters,
so the sum's gradient is every node's own gradient, which the JAX
package gets from a ``vmap`` of ``value_and_grad``.  The CUDA kernels
never carry a gradient (their wrappers refuse inputs that require one).

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
Each stage of a round runs inside a ``torch.profiler.record_function``
span (``round.draws``, ``round.mixing_operator``, ``round.gossip``,
``round.local_step``, ``round.mask``, ``round.eval``, ``chunk.sync``;
with ``gossip_impl="masked"``, ``round.secure_mask`` inside
``round.gossip``), so a profile splits a round's time by stage; without
an active profiler a span costs a few microseconds of host time.

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

Not ported yet: the sharded mixer and multi-host runs
(``core.gossip_plan`` refuses their knobs) and a custom loss function.
"""
from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.config import FLConfig
from repro_torch.core.chunked import engine_chunk
from repro_torch.core.async_sched import bernoulli_active, markov_active, staleness_update
from repro_torch.core.gossip_plan import resolve_gossip_plan
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
    ``by[n]``, through the plain differentiable forward
    ``model.apply_nodes``.  Rows share no parameters, so one backward of
    the summed losses gives every row its own gradient (the JAX package
    takes a ``vmap`` of ``value_and_grad``).  The trainer's local step
    and the cold-start fine-tune (``core.personalize``) both use it."""
    p = params.detach().requires_grad_(True)
    with torch.enable_grad():
        pred = model.apply_nodes(layout.views(p), bx)
        losses = torch.mean(torch.square(pred - by), dim=1)
        (grads,) = torch.autograd.grad(losses.sum(), p)
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
            cluster_size=cfg.cluster_size, device=self.device,
        )
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

    def to_device(self, x, y, counts) -> FedTensors:
        """The federation's padded arrays as tensors on the device."""
        return FedTensors.of(x, y, counts, self.device)

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
            p_apply, state = self.optimizer.update(grads, state, p_apply)
            p_grad = p_apply
            losses.append(loss)
        return p_apply, state, torch.stack(losses).mean(dim=0)

    def round(self, state: FLState, data: FedTensors, draws: RoundDraws):
        """One FL round: returns ``(new_state, loss)``, the loss the
        active-weighted mean of the nodes' losses, as a 0-d tensor on the
        device (no host sync)."""
        cfg = self.cfg
        n = cfg.num_nodes
        with record_function("round.mixing_operator"):
            active, operand, adj = self.mixing_operator(state, draws)
        premix = state.params
        noise = None
        if self.dp_noise_sigma > 0.0:
            if draws.dp_noise is None:
                raise ValueError("dp_noise_sigma > 0 needs RoundDraws.dp_noise")
            noise = self.dp_noise_sigma * draws.dp_noise
        with record_function("round.gossip"):
            mask_ctx = (self.mask_source, adj) if self.plan.masked else None
            mixed = self.plan.gossip(premix, operand, active, noise, mask_ctx)
        with record_function("round.local_step"):
            new_params, new_opt, losses = self._local_step(
                premix, mixed, state.opt_state, data, draws.batch_idx, self._shift)

        # inactive nodes keep their params and optimizer rows: a
        # where-select, so they are bitwise copies and int32 leaves stay int32
        def keep_inactive(new, old):
            if new is None:
                return None
            return torch.where(active.reshape((n,) + (1,) * (new.dim() - 1)) > 0, new, old)

        with record_function("round.mask"):
            params = keep_inactive(new_params, premix)
            opt_state = {k: keep_inactive(v, state.opt_state[k]) for k, v in new_opt.items()}
            loss = torch.sum(losses * active) / torch.clamp_min(torch.sum(active), 1.0)
            staleness = staleness_update(state.staleness, active)
        return FLState(params, opt_state, staleness, state.round + 1), loss

    def mixing_operator(self, state: FLState, draws: RoundDraws):
        """The round's active mask, mixing operator (dense matrix or
        neighbor table) and adjacency (None when a static topology's
        table is built from its candidates)."""
        cfg = self.cfg
        n = cfg.num_nodes
        if cfg.schedule == "markov":
            # a node with staleness 0 took part in the last round
            prev_active = (state.staleness == 0).to(torch.float32)
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
        param dict (views into one new (D,) vector)."""
        return self.layout.row(state.params.mean(dim=0))

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
        history does not depend on either."""
        chunk = engine_chunk(engine, chunk, 0)[0]
        rounds = self.cfg.rounds if rounds is None else rounds
        data = self.to_device(x, y, counts)
        if state is None:
            state = self.init(generator)
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
                with record_function("round.draws"):
                    rd = next(stream) if stream is not None else self.draw(generator, data, batch_size)
                state, loss = self.round(state, data, rd)
                losses.append(loss)
                if do_eval and (t + i + 1) % eval_every == 0:
                    with record_function("round.eval"):
                        evals[i] = eval_record(resolved(self.population(state), val_x, val_y))
            # one host sync per chunk: losses and eval records together
            with record_function("chunk.sync"):
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
    def _scenarios(self, grid: SweepGrid) -> _Scenarios:
        """The grid's knobs on the device.  Unarmed axes fall back to the
        trainer's own: its DP sigma and its config's data skew for every
        scenario, as in the JAX package."""
        dev, g, n = self.device, grid.size, self.cfg.num_nodes
        sigma = grid.dp_sigma
        if sigma is None and self.dp_noise_sigma > 0.0:
            sigma = torch.full((g,), self.dp_noise_sigma)
        skew = grid.skew
        if skew is None and self.cfg.data_skew != 0.0:
            skew = torch.full((g,), self.cfg.data_skew)
        shift = None
        if skew is not None:
            offsets = torch.from_numpy(node_skew_offsets(n))
            shift = (skew[:, None] * offsets[None, :]).reshape(-1).to(dev)
        sources = None
        if self.plan.masked:
            sources = sweep_mask_sources(grid.seeds, self.layout.dim, dev)
        return _Scenarios(
            adjacency=grid.adjacency.to(dev), resample=grid.resample.to(dev),
            inactive_ratio=grid.inactive_ratio.to(dev),
            markov=None if grid.markov is None else grid.markov.to(dev),
            sigma=None if sigma is None else sigma.repeat_interleave(n)[:, None].to(dev),
            shift=shift, mask_sources=sources,
        )

    def sweep_round(self, state: FLState, data: FedTensors, draws: RoundDraws,
                    sc: _Scenarios):
        """One round of every scenario: ``state`` holds the flat (G·N, ...)
        rows, ``draws`` the G scenarios' draws stacked (``draw_sweep``).
        Returns ``(new_state, losses)``, each scenario's active-weighted
        mean loss as a (G,) tensor on the device."""
        cfg = self.cfg
        g, n = draws.u_act.shape
        with record_function("round.mixing_operator"):
            active = bernoulli_active(draws.u_act, sc.inactive_ratio)
            if sc.markov is not None:
                # both schedules read the same uniforms: arming the axis moves no draw
                prev_active = (state.staleness.view(g, n) == 0).to(torch.float32)
                sticky = markov_active(draws.u_act, prev_active, cfg.p_stay_active,
                                       cfg.p_stay_inactive)
                active = torch.where(sc.markov[:, None] > 0, sticky, active)
            adj = sc.adjacency
            if draws.scores is not None:
                drawn = random_adjacency(draws.scores, min(cfg.comm_batch, n - 1))
                adj = torch.where(sc.resample[:, None, None] > 0, drawn, adj)
            operand = self.plan.build_repr(adj, active)
        premix = state.params
        noise = None
        if sc.sigma is not None:
            if draws.dp_noise is None:
                raise ValueError("a DP sweep needs RoundDraws.dp_noise")
            noise = sc.sigma * draws.dp_noise.view(g * n, -1)
        with record_function("round.gossip"):
            mask_ctx = None if sc.mask_sources is None else (sc.mask_sources, adj)
            mixed = self.plan.sweep_gossip(premix, operand, active, noise, mask_ctx)
        with record_function("round.local_step"):
            new_params, new_opt, losses = self._local_step(
                premix, mixed, state.opt_state, data,
                draws.batch_idx.view(g * n, *draws.batch_idx.shape[2:]), sc.shift)
        rows = active.reshape(-1)

        def keep_inactive(new, old):
            if new is None:
                return None
            return torch.where(rows.reshape((g * n,) + (1,) * (new.dim() - 1)) > 0, new, old)

        with record_function("round.mask"):
            params = keep_inactive(new_params, premix)
            opt_state = {k: keep_inactive(v, state.opt_state[k]) for k, v in new_opt.items()}
            loss = (torch.sum(losses.view(g, n) * active, dim=1)
                    / torch.clamp_min(torch.sum(active, dim=1), 1.0))
            staleness = staleness_update(state.staleness, rows)
        return FLState(params, opt_state, staleness, state.round + 1), loss

    def populations(self, state: FLState, g: int) -> torch.Tensor:
        """Each scenario's population model (the mean of its N rows of the
        flat (G·N, D) params) as a (G, D) tensor."""
        return state.params.view(g, self.cfg.num_nodes, -1).mean(dim=1)

    def sweep_val_rmse(self, pops: torch.Tensor, val_x: torch.Tensor,
                       val_y: torch.Tensor) -> torch.Tensor:
        """Each population's val RMSE, (G,) on the device: one forward of
        the G models over the shared windows (on CUDA one
        ``lstm_forward`` launch with G groups)."""
        with torch.no_grad():
            pred = self.model.apply_groups(self.layout.views(pops), val_x)
            return torch.sqrt(torch.mean(torch.square(pred - val_y), dim=1))

    def _sweep_eval(self, state: FLState, g: int, eval_fn: Callable | None, val_x,
                    val_y) -> dict[str, torch.Tensor]:
        """One eval round of every scenario: each key's (G,) values, from
        the resolved ``eval_fn`` once a scenario, or (None) the built-in
        val RMSE of all G populations in one forward."""
        pops = self.populations(state, g)
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
        refused (``GossipPlan.require_sweep``)."""
        self.plan.require_sweep()
        n = self.cfg.num_nodes
        if grid.adjacency.shape[-1] != n:
            raise ValueError(f"grid built for N={grid.adjacency.shape[-1]} nodes but "
                             f"cfg.num_nodes={n}")
        g = grid.size
        rounds = self.cfg.rounds if rounds is None else rounds
        data = self.to_device(x, y, counts)
        if generators is None and (states is None or draws is None):
            generators = [torch.Generator(device=self.device).manual_seed(seed)
                          for seed in grid.seeds]
        if states is None:
            state = self._fresh_state(torch.cat([self._draw_params(gen) for gen in generators]))
        else:
            state = states.reshaped((g * n,))
        sc = self._scenarios(grid)
        stream: Iterator[RoundDraws] | None = None if draws is None else iter(draws)
        resample = [bool(v) for v in grid.resample.tolist()]
        dp_dim = self.layout.dim if sc.sigma is not None else 0
        val_x, val_y = self._val_tensors(val_data)
        do_eval = bool(eval_every) and (eval_fn is not None or val_data is not None)
        resolved = None if eval_fn is None else self.resolve_eval_fn(eval_fn)
        chunk = max(1, min(chunk or DEFAULT_CHUNK, rounds))
        histories: list[list[dict]] = [[] for _ in range(g)]
        t = 0
        while t < rounds:
            c = min(chunk, rounds - t)
            losses, evals = [], {}
            for i in range(c):
                with record_function("round.draws"):
                    rd = next(stream) if stream is not None else draw_sweep(
                        generators, data.counts, local_steps=self.cfg.local_steps,
                        batch_size=batch_size, resample=resample, dp_dim=dp_dim)
                state, loss = self.sweep_round(state, data, rd, sc)
                losses.append(loss)
                if do_eval and (t + i + 1) % eval_every == 0:
                    with record_function("round.eval"):
                        evals[i] = self._sweep_eval(state, g, resolved, val_x, val_y)
            # one host sync per chunk for the whole grid
            with record_function("chunk.sync"):
                host = iter(read_host([torch.stack(losses, dim=1)]
                                      + [v for rec in evals.values() for v in rec.values()]))
            losses_host = next(host)  # scenario-major: (G, c)
            for s in range(g):
                histories[s] += [{"round": t + i, "loss": losses_host[s * c + i]}
                                 for i in range(c)]
            for i, rec in evals.items():
                for k in rec:
                    for s, v in enumerate(next(host)):
                        histories[s][t + i][k] = v
            t += c
        pops = self.layout.views(self.populations(state, g))
        return pops, histories, state.reshaped((g, n))
