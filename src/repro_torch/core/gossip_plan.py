"""The gossip pipeline, resolved once per trainer (the counterpart of
``repro.core.gossip_plan``).

A :class:`GossipPlan` holds every knob decision:

  * the representation of the round's mixing operator, ``"dense"``
    (the (N, N) ``mixing_matrix``) or ``"sparse"`` (the (N, B+1)
    neighbor table); ``"auto"`` picks sparse once ``N >= 4 (B + 1)``
    (:func:`choose_gossip_repr`);
  * the mix backend, from the registry below (:func:`mix_backends`):
    ``"tree"`` (the plain PyTorch reference contractions), ``"kernel"``
    (the hand-written CUDA kernels on the card), ``"sharded"`` (the
    federation's rows split over ``torch.distributed`` ranks,
    ``core.distributed``: the ``allgather``, ``psum`` and ``masked``
    schedules) and ``"sharded_gather_tables"`` (the sharded mixer's
    ``gather`` schedule, sparse only).  Each backend declares its
    capabilities (:class:`BackendCaps`), and every refusal is raised
    here, at resolution, from them;
  * the local-DP stage: the kernel backend fuses noise, mix and the
    clean self-restore into one pass; every other backend composes them
    (noise-add -> mix -> self-restore), the sharded ones on the rank's
    rows;
  * the gossip schedule, ``gossip_impl``: the tree and kernel mixers
    accept and ignore ``allgather``/``psum``; ``"masked"`` adds the
    pairwise-mask cancellation term of ``core.secure_agg`` to the final
    mixed state, after the DP stage, so a masked run is the bitwise twin
    of its unmasked one on every backend, representation and DP
    setting.  ``"auto"`` is resolved before the plan by
    :func:`choose_gossip_impl`.

The sweep engine (``GluADFL.train_sweep``) runs G scenarios' stacked
``(G·N, D)`` rows through :meth:`GossipPlan.sweep_gossip` on the tree
backend and the sharded one's ``allgather``, ``psum`` and ``masked``
schedules (:meth:`GossipPlan.require_sweep` refuses the kernel mixer
and the gather tables, as the JAX package does).  On the tree backend
the dense operator is a batched ``(G, N, N) @ (G, N, D)``, the sparse
one a single gather over the ``(G·N, B+1)`` table with scenario g's
indices offset by ``g·N``.  On the sharded backend a plan resolved on
a :class:`~repro_torch.launch.mesh.SweepMesh` mixes the rank's
``(G / grid_width) · (N / node_width)`` rows through the grid-batched
forms of ``core.distributed`` over the mesh's node subgroup.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.distributed import (
    GOSSIP_IMPLS,
    GOSSIP_REPRS,
    _default_federation_mesh,
    sharded_gossip_mix,
    sharded_gossip_mix_gather,
    sharded_gossip_mix_sparse,
)
from repro_torch.core.gossip import (
    gossip_dp_composed,
    gossip_mix_masked,
    gossip_mix_sparse_tree,
    gossip_mix_tree,
)
from repro_torch.core.topology import mixing_matrix, neighbor_candidates, neighbor_table
from repro_torch.kernels import ops
from repro_torch.utils.tracing import span

# the mixer knob's legal values (``gossip_impl="gather"`` reroutes the
# sharded mixer to the sharded_gather_tables backend)
MIXERS = ("tree", "kernel", "sharded")

class GossipPlanError(ValueError):
    """A knob value or combination the registry does not resolve."""


@dataclass(frozen=True)
class BackendCaps:
    """Declared capabilities of one registered mix backend."""

    supports_sparse: bool
    supports_dense: bool
    supports_sweep_grid: bool
    supports_multihost: bool
    memory_class: str        # per-device working set of the contraction
    fused_dp: bool           # noise + mix + self-restore in one pass
    uses_mesh: bool          # runs over a FederationMesh's ranks


@dataclass(frozen=True)
class MixBackend:
    """One registered mix backend: ``build(impl, sparse, mesh)`` returns
    the plain mix ``mix(w, operand, active)`` with the schedule and the
    mesh bound, so the round holds a plain closure."""

    name: str
    mixer: str                   # the mixer knob value this backend serves
    impls: tuple[str, ...]       # wire schedules it accepts
    caps: BackendCaps
    build: Callable
    summary: str
    sweep_refusal: str | None = None   # message when supports_sweep_grid=False


_REGISTRY: dict[str, MixBackend] = {}


def register_mix_backend(backend: MixBackend) -> MixBackend:
    """Register a mix backend (the latest registration of a name wins)."""
    _REGISTRY[backend.name] = backend
    return backend


def mix_backends() -> dict[str, MixBackend]:
    """A copy of the backend registry, keyed by backend name."""
    return dict(_REGISTRY)


def _build_tree(impl, sparse, mesh):
    if sparse:
        return lambda w, op, active: gossip_mix_sparse_tree(w, op[0], op[1], active)
    # dense identity rows already encode inactivity, as in the JAX tree path
    return lambda w, op, active: gossip_mix_tree(w, op)


def _build_kernel(impl, sparse, mesh):
    if sparse:
        return lambda w, op, active: ops.gossip_mix_sparse(op[0], op[1], w, active)
    return lambda w, op, active: ops.gossip_mix(op, w, active)


def _build_sharded(impl, sparse, mesh):
    # on a SweepMesh the 3-D (Gb, N, ...) operators pick the grid forms
    if sparse:
        return lambda w, op, active: sharded_gossip_mix_sparse(w, op[0], op[1], active,
                                                               mesh=mesh)
    # dense identity rows already encode inactivity: no active mask
    return lambda w, op, active: sharded_gossip_mix(w, op, mesh=mesh, impl=impl)


def _build_gather_tables(impl, sparse, mesh):
    return lambda w, op, active: sharded_gossip_mix_gather(w, op[0], op[1], active, mesh=mesh)


register_mix_backend(MixBackend(
    name="tree",
    mixer="tree",
    # the schedule only matters to the sharded mixer; tree and kernel
    # accept every schedule but gather and ignore it (masked composes
    # through the cancellation term either way)
    impls=("allgather", "psum", "masked"),
    caps=BackendCaps(
        supports_sparse=True, supports_dense=True,
        supports_sweep_grid=True, supports_multihost=False,
        memory_class="one process, O(N·D)", fused_dp=False, uses_mesh=False,
    ),
    build=_build_tree,
    summary="plain PyTorch contraction of the (N, D) matrix (the CPU path)",
))

register_mix_backend(MixBackend(
    name="kernel",
    mixer="kernel",
    impls=("allgather", "psum", "masked"),
    caps=BackendCaps(
        supports_sparse=True, supports_dense=True,
        supports_sweep_grid=False, supports_multihost=False,
        memory_class="one device, O(N·D), column tiles in shared memory", fused_dp=True,
        uses_mesh=False,
    ),
    build=_build_kernel,
    summary="hand-written CUDA kernels (kernels.ops); fuse the local-DP pass",
    sweep_refusal=("train_sweep batches the tree mixer; mixer='kernel' (the CUDA kernels) "
                   "is a per-scenario program -- use serial train() for it"),
))

register_mix_backend(MixBackend(
    name="sharded",
    mixer="sharded",
    impls=("allgather", "psum", "masked"),
    caps=BackendCaps(
        supports_sparse=True, supports_dense=True,
        supports_sweep_grid=True, supports_multihost=True,
        memory_class="allgather O(N·D) / psum O(N/W·D) per rank",
        fused_dp=False, uses_mesh=True,
    ),
    build=_build_sharded,
    summary="torch.distributed collectives over the ranks' row blocks",
))

register_mix_backend(MixBackend(
    name="sharded_gather_tables",
    mixer="sharded",
    impls=("gather",),
    caps=BackendCaps(
        supports_sparse=True, supports_dense=False,
        supports_sweep_grid=False, supports_multihost=True,
        memory_class="two row blocks O(N/W·D) per rank, no gathered (N·D)",
        fused_dp=False, uses_mesh=True,
    ),
    build=_build_gather_tables,
    summary="ranks' (N/W, B+1) table rows + send/recv ring rotation of the row blocks",
    sweep_refusal=("train_sweep batches the tree or sharded allgather/psum/masked schedules; "
                   "gossip_impl='gather' (sharded gather tables) is the single-run scale-out "
                   "schedule -- use allgather/psum for swept-sharded runs"),
))


def _backend_for(mixer: str, gossip_impl: str) -> MixBackend:
    """Route (mixer, impl) to a registered backend, or raise."""
    for backend in _REGISTRY.values():
        if backend.mixer == mixer and gossip_impl in backend.impls:
            return backend
    takers = sorted(b.mixer for b in _REGISTRY.values() if gossip_impl in b.impls)
    raise GossipPlanError(
        f"gossip_impl {gossip_impl!r} has no backend for mixer={mixer!r}"
        + (f" (it needs mixer in {takers})" if takers else ""))


# per-rank budget for the gathered (N, D) federation before the
# allgather schedule's memory outweighs its one dense collective
DEFAULT_GATHER_BUDGET_BYTES = 1 << 30


def choose_gossip_impl(num_nodes: int, param_bytes_per_node: int, *, shards: int | None = None,
                       budget_bytes: int = DEFAULT_GATHER_BUDGET_BYTES,
                       secure: bool = False) -> str:
    """``--gossip-impl auto``: ``"allgather"`` while the gathered
    federation, ``num_nodes * param_bytes_per_node`` bytes on every
    rank, fits ``budget_bytes`` (or there is one shard), else ``"psum"``
    (O(N/shards · D) a rank).  ``shards`` defaults to the federation
    mesh's width.  ``secure=True`` gives ``"masked"``, which rides the
    allgather schedule, and raises rather than drop the privacy layer
    when the gathered federation exceeds the budget over several
    shards."""
    if shards is None:
        shards = _node_axis_width(_default_federation_mesh(num_nodes))
    gathered = num_nodes * param_bytes_per_node
    if secure:
        if shards > 1 and gathered > budget_bytes:
            raise GossipPlanError(
                f"secure (masked) gossip rides the allgather schedule, but the gathered "
                f"federation ({gathered} bytes) exceeds the per-rank budget ({budget_bytes}); "
                f"shrink the model or raise budget_bytes")
        return "masked"
    if shards <= 1:
        return "allgather"
    return "allgather" if gathered <= budget_bytes else "psum"


# sparse tables win once the kept row (B+1 entries) is a small fraction
# of N; 4x covers the gather bookkeeping the dense matmul doesn't pay
SPARSE_GOSSIP_FACTOR = 4


def _node_axis_width(mesh) -> int:
    """The width the gossip collectives run over: a federation mesh's W,
    or a sweep mesh's node width (its grid axis only batches)."""
    return mesh.node_width if mesh.axis_names == ("grid", "node") else mesh.width


def choose_gossip_repr(num_nodes: int, comm_batch: int, *, factor: int = SPARSE_GOSSIP_FACTOR,
                       mesh=None, budget_bytes: int = DEFAULT_GATHER_BUDGET_BYTES) -> str:
    """``--gossip-repr auto``: the sparse table once
    ``num_nodes >= factor * (comm_batch + 1)`` (sparse at the paper's
    N=226, B=7; dense at ohiot1dm's N=12).  With a federation ``mesh``,
    sparse is also forced once a rank's (N/W, N) fp32 block of the
    dense matrix alone outgrows ``budget_bytes`` (a sweep mesh: W its
    node width)."""
    if num_nodes >= factor * (comm_batch + 1):
        return "sparse"
    if mesh is not None and (num_nodes // _node_axis_width(mesh)) * num_nodes * 4 > budget_bytes:
        return "sparse"
    return "dense"


@dataclass(frozen=True, eq=False)
class GossipPlan:
    """One resolved mixing pipeline; the round calls :meth:`build_repr`
    and :meth:`gossip` (a swept round :meth:`sweep_gossip`).  On a
    sharded backend the params handed to :meth:`gossip` are the rank's
    rows ``mesh.rows`` (of each of its scenarios, on a sweep mesh) and
    the operator and activity are global."""

    mixer: str
    backend: str                     # registered backend name
    gossip_repr: str                 # "dense" | "sparse", never "auto"
    gossip_impl: str                 # never "auto"
    comm_batch: int
    caps: BackendCaps
    mesh: Any = None                 # FederationMesh or SweepMesh of a sharded backend
    neighbor_cand: Any = None        # static-topology candidates (sparse)
    _mix: Callable = None
    _dp: Callable = None
    _sweep_refusal: str | None = None

    @property
    def masked(self) -> bool:
        return self.gossip_impl == "masked"

    @property
    def rows(self) -> slice:
        """The global rows this process's params hold (all of them off
        the sharded backends)."""
        return slice(None) if self.mesh is None else self.mesh.rows

    def build_repr(self, adj: torch.Tensor, active: torch.Tensor):
        """The round's operator: the (N, N) matrix or the ``(idx, wgt)``
        table built from a dense adjacency."""
        if self.gossip_repr == "sparse":
            return neighbor_table(adj, active, self.comm_batch)
        return mixing_matrix(adj, active, self.comm_batch)

    def require_sweep(self) -> None:
        """Raise the backend's refusal unless it can batch a sweep grid."""
        if not self.caps.supports_sweep_grid:
            raise NotImplementedError(self._sweep_refusal
                                      or f"backend {self.backend!r} does not support train_sweep")

    def require_multihost(self) -> None:
        """Raise unless the backend spans processes (a run over several
        ranks needs the node axis split over them)."""
        if not self.caps.supports_multihost:
            raise ValueError(f"multi-process training needs mixer='sharded' (the node axis "
                             f"must span the ranks), got mixer={self.mixer!r}")

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
        """One round's mixing step; ``noise`` is the DP noise of
        ``premix``'s rows already scaled by sigma, or None when DP is
        off.  ``mask_ctx``, ``(mask source, adjacency)`` on a masked
        plan, adds the cancellation term of this process's rows after
        the mix and the DP stage, inside a ``round.secure_mask`` span
        (the table, the masks and the term); the source draws the whole
        round's masks, so every rank's masks are those of one process."""
        if noise is None:
            out = self._mix(premix, operand, active)
        else:
            out = self._dp(premix, noise, operand, active)
        if mask_ctx is not None:
            source, adj = mask_ctx
            with span("round.secure_mask"):
                idx, wgt = self.mask_table(operand, adj, active)
                rows = self.rows
                out = gossip_mix_masked(out, idx[rows], wgt[rows], source(idx, wgt)[rows])
        return out

    def sweep_gossip(self, premix: torch.Tensor, operand, active: torch.Tensor,
                     noise: torch.Tensor | None = None, mask_ctx=None) -> torch.Tensor:
        """One swept round's mixing step over G scenarios: ``premix`` and
        ``noise`` (G·k, D), row ``g·k + i`` row i of scenario g (k = N,
        or a rank's N / node_width rows on the sharded backend);
        ``operand`` the stacked (G, N, N) matrices or (G, N, B+1)
        tables of :meth:`build_repr`; ``active`` (G, N).  On the tree
        backend the sparse tables become one (G·N, B+1) table, scenario
        g's indices offset by ``g·N``; on the sharded backend (a plan on
        a sweep mesh) the grid forms take the stacked operators.
        ``mask_ctx``, ``(G mask sources, (G, N, N) adjacency)`` on a
        masked plan, adds each scenario's cancellation term over this
        process's rows from its own source, scenario by scenario (one
        scenario's masks at a time)."""
        self.require_sweep()
        g, n = active.shape
        if self.caps.uses_mesh:
            out = self.gossip(premix, operand, active, noise)
        else:
            flat = operand
            if self.gossip_repr == "sparse":
                idx, wgt = operand
                offset = (torch.arange(g, dtype=idx.dtype, device=idx.device) * n)[:, None, None]
                flat = ((idx + offset).view(g * n, -1), wgt.reshape(g * n, -1))
            out = self.gossip(premix, flat, active.reshape(-1), noise)
        if mask_ctx is not None:
            sources, adj = mask_ctx
            with span("round.secure_mask"):
                idx, wgt = self.mask_table(operand, adj, active)
                rows = self.rows
                blocks = out.view(g, out.shape[0] // g, -1)
                out = torch.cat([gossip_mix_masked(blocks[s], idx[s][rows], wgt[s][rows],
                                                   sources[s](idx[s], wgt[s])[rows])
                                 for s in range(g)])
        return out


def _resolve_dp_stage(backend: MixBackend, sparse: bool, mix_fn: Callable, rows: slice):
    """The DP stage: the kernel backend's fused kernels; every other
    backend composes noise-add -> mix -> self-restore
    (``core.gossip.gossip_dp_composed``) on the ``rows`` its params hold."""
    if backend.caps.fused_dp:
        if sparse:
            return lambda premix, noise, op, active: ops.gossip_mix_sparse_dp(
                op[0], op[1], premix, noise, active)
        return lambda premix, noise, op, active: ops.gossip_mix_dp(op, premix, noise, active)

    def dp(premix, noise, op, active):
        return gossip_dp_composed(mix_fn, premix, noise, op, active, rows)
    return dp


def resolve_gossip_plan(
    *,
    mixer: str | None = None,
    gossip_impl: str = "allgather",
    gossip_repr: str = "dense",
    num_nodes: int,
    comm_batch: int,
    topology: str | None = None,
    cluster_size: int = 4,
    mesh=None,
    device=None,
) -> GossipPlan:
    """Resolve the knobs into a :class:`GossipPlan`, or raise
    :class:`GossipPlanError` naming the knob.  A sharded backend runs
    over ``mesh`` (default: the federation mesh of the default process
    group).  For a static topology under the sparse representation, the
    neighbor candidates are built here once (on ``device``), so no
    (N, N) array is built per round."""
    mixer = "tree" if mixer is None else mixer
    if mixer not in MIXERS:
        raise GossipPlanError(f"mixer {mixer!r} not in {MIXERS}")
    if gossip_impl not in GOSSIP_IMPLS:
        raise GossipPlanError(f"gossip_impl {gossip_impl!r} not in {GOSSIP_IMPLS}; 'auto' "
                              f"resolves through choose_gossip_impl before the plan")
    if gossip_repr == "auto":
        gossip_repr = choose_gossip_repr(num_nodes, comm_batch, mesh=mesh)
    if gossip_repr not in GOSSIP_REPRS:
        raise GossipPlanError(f"gossip_repr {gossip_repr!r} not in {GOSSIP_REPRS} or 'auto'")
    backend = _backend_for(mixer, gossip_impl)
    sparse = gossip_repr == "sparse"
    if not (backend.caps.supports_sparse if sparse else backend.caps.supports_dense):
        raise GossipPlanError(
            f"gossip_impl {gossip_impl!r} (backend {backend.name!r}) needs gossip_repr='sparse': "
            f"the gather-table schedule shards the (N, B+1) neighbor tables -- there is no "
            f"dense (N, N) variant")
    if backend.caps.uses_mesh:
        mesh = mesh or _default_federation_mesh(num_nodes, device)
        if mesh.num_nodes != num_nodes:
            raise GossipPlanError(f"the mesh splits N={mesh.num_nodes} nodes, the federation "
                                  f"has {num_nodes}")
    else:
        mesh = None
    mix_fn = backend.build(gossip_impl, sparse, mesh)
    dp_fn = _resolve_dp_stage(backend, sparse, mix_fn, slice(None) if mesh is None else mesh.rows)
    cand = None
    if sparse and topology is not None:
        cand = neighbor_candidates(topology, num_nodes, cluster_size)
        if cand is not None and device is not None:
            cand = tuple(t.to(device) for t in cand)
    return GossipPlan(mixer, backend.name, gossip_repr, gossip_impl, comm_batch, backend.caps,
                      mesh, cand, mix_fn, dp_fn, backend.sweep_refusal)


def supported_cells() -> list[dict]:
    """Every (mixer, gossip_impl, gossip_repr) cell the registry
    resolves, with its backend name and capabilities."""
    cells = []
    for mixer in MIXERS:
        for impl in GOSSIP_IMPLS:
            for repr_ in GOSSIP_REPRS:
                try:
                    plan = resolve_gossip_plan(mixer=mixer, gossip_impl=impl, gossip_repr=repr_,
                                               num_nodes=8, comm_batch=2)
                except GossipPlanError:
                    continue
                cells.append({
                    "mixer": mixer,
                    "gossip_impl": impl,
                    "gossip_repr": repr_,
                    "backend": plan.backend,
                    "sweep": plan.caps.supports_sweep_grid,
                    "multihost": plan.caps.supports_multihost,
                    "memory_class": plan.caps.memory_class,
                })
    return cells
