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
syncs with the host once per ``chunk`` rounds (``chunk=1`` is the JAX
package's loop engine); the numbers do not depend on ``chunk``.
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
Not ported yet: the sweep engine, the sharded mixer and multi-host
runs (``core.gossip_plan`` refuses their knobs), custom loss and eval
functions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.config import FLConfig
from repro_torch.core.async_sched import bernoulli_active, markov_active, staleness_update
from repro_torch.core.gossip_plan import resolve_gossip_plan
from repro_torch.core.secure_agg import MaskSource, edge_mask_source, mask_generator
from repro_torch.core.topology import (
    neighbor_table_from_candidates,
    random_adjacency,
    static_adjacency,
)
from repro_torch.data.synth import node_skew_offsets
from repro_torch.device import resolve_device
from repro_torch.models.base import Model
from repro_torch.optim import Optimizer
from repro_torch.utils.pytree import ParamLayout
from repro_torch.utils.rng import RoundDraws, draw_round

# rounds between host syncs of the scan engine's losses and eval records
DEFAULT_CHUNK = 32


@dataclass
class FLState:
    params: torch.Tensor            # (N, D) float32, row n = node n
    opt_state: dict                 # leaves (N, ...) or None
    staleness: torch.Tensor         # (N,) float32
    round: int


@dataclass
class FedTensors:
    """The federation's padded training data on the trainer's device."""

    x: torch.Tensor        # (N, M, L) float32
    y: torch.Tensor        # (N, M)
    counts: torch.Tensor   # (N,) int64


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
        ``(N, *shape)``, tensors or arrays): optimizer state at zero,
        staleness 0, round 0."""
        leaves = {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, np.float32))
                  for k, v in stacked.items()}
        params = self.layout.flatten(leaves).to(self.device)
        n = self.cfg.num_nodes
        if params.shape != (n, self.layout.dim):
            raise ValueError(f"params must stack {n} nodes of {self.layout.dim} values, "
                             f"got {tuple(params.shape)}")
        return FLState(
            params=params,
            opt_state=self.optimizer.init(params),
            staleness=torch.zeros(n, device=self.device),
            round=0,
        )

    def init(self, generator: torch.Generator) -> FLState:
        """Draw every node's params from ``generator``, node 0 first (the
        JAX package's scales; not its numbers)."""
        rows = [self.model.init(generator, device=self.device) for _ in range(self.cfg.num_nodes)]
        return self.state_from_params({k: torch.stack([r[k] for r in rows]) for k in rows[0]})

    def to_device(self, x, y, counts) -> FedTensors:
        """The federation's padded arrays as tensors on the device."""
        dev = self.device
        return FedTensors(
            x=torch.as_tensor(np.asarray(x, np.float32)).to(dev),
            y=torch.as_tensor(np.asarray(y, np.float32)).to(dev),
            counts=torch.as_tensor(np.asarray(counts, np.int64)).to(dev),
        )

    def draw(self, generator: torch.Generator, data: FedTensors, batch_size: int) -> RoundDraws:
        """One round's draws from ``generator`` (on the trainer's device)."""
        return draw_round(
            generator, data.counts, local_steps=self.cfg.local_steps, batch_size=batch_size,
            random_topology=self._static_adj is None and self.plan.neighbor_cand is None,
            dp_dim=self.layout.dim if self.dp_noise_sigma > 0.0 else 0,
        )

    # ------------------------------------------------------------------
    def _local_step(self, premix, mixed, opt_state, data: FedTensors, batch_idx):
        """``local_steps`` optimizer steps for every node: the first
        gradient at the pre-mix (or mixed) params, applied to the mixed
        ones; later steps are ordinary steps.  Returns the new params,
        optimizer state and each node's mean loss."""
        p_grad = premix if self.grad_at == "premix" else mixed
        p_apply, state = mixed, opt_state
        seq = data.x.shape[2]
        losses = []
        for s in range(batch_idx.shape[1]):
            idx = batch_idx[:, s]
            bx = torch.gather(data.x, 1, idx[:, :, None].expand(-1, -1, seq))
            by = torch.gather(data.y, 1, idx)
            if self._shift is not None:
                bx = bx + self._shift[:, None, None]
                by = by + self._shift[:, None]
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
                premix, mixed, state.opt_state, data, draws.batch_idx)

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

    def val_rmse(self, state: FLState, val_x: torch.Tensor, val_y: torch.Tensor) -> torch.Tensor:
        """The population model's validation RMSE (0-d, on the device);
        on CUDA the forward is the ``lstm_forward`` kernel."""
        with torch.no_grad():
            pred = self.model.apply(self.population(state), val_x)
            return torch.sqrt(torch.mean(torch.square(pred - val_y)))

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
        val_data: tuple | None = None,
        chunk: int | None = None,
        state: FLState | None = None,
        draws: Iterable[RoundDraws] | None = None,
    ):
        """Run T rounds; returns ``(population_params, history, state)``.

        ``generator`` (on the trainer's device) draws the initial params
        unless ``state`` is given, and each round's draws unless
        ``draws`` yields them.  With ``eval_every > 0`` and ``val_data``,
        the population's val RMSE joins the history record of every
        round t with ``(t + 1) % eval_every == 0``.  The host syncs once
        per ``chunk`` rounds (default :data:`DEFAULT_CHUNK`); the history
        does not depend on it."""
        rounds = self.cfg.rounds if rounds is None else rounds
        data = self.to_device(x, y, counts)
        if state is None:
            state = self.init(generator)
        stream: Iterator[RoundDraws] | None = None if draws is None else iter(draws)
        do_eval = bool(eval_every) and val_data is not None
        if do_eval:
            val_x, val_y = (torch.as_tensor(np.asarray(v, np.float32)).to(self.device)
                            for v in val_data)
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
                        evals[i] = self.val_rmse(state, val_x, val_y)
            # one host sync per chunk: losses and eval records together
            with record_function("chunk.sync"):
                host = torch.stack(losses + list(evals.values())).cpu().tolist()
            for i in range(c):
                history.append({"round": t + i, "loss": host[i]})
            for j, i in enumerate(evals):
                history[t + i]["val_rmse"] = host[c + j]
            t += c
        return self.population(state), history, state
