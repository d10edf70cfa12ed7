"""The federation's layout over ranks (the counterpart of
``repro.launch.mesh``'s 1-axis ``("node",)`` federation mesh).

One process owns one rank of ``torch.distributed``'s default group, and
one rank owns one device, so the node axis is split over the world:
:func:`make_federation_mesh` gives every rank the contiguous block of
``k = N / W`` federation rows ``[rank·k, (rank+1)·k)``, in rank order,
as the JAX package's mesh orders its shards by process.  The width is
the world size ``W``, never less: a process that held no rows would
have nothing to train, so ``N % W != 0`` is refused, naming N and W (the
JAX package's ``process_row_slice`` fails the same way when a process
owns no shards).  REPLACE-BG's N=226 = 2 x 113 therefore runs on 1 or 2
ranks, and 4 ranks are refused.

Without an initialized process group (one process) the mesh has no
group, width 1 and every row, and the sharded mixer runs no collective.

The swept-sharded engine (``GluADFL.train_sweep`` with
``mixer="sharded"``) lays the W ranks out as JAX's 2-D ``("grid",
"node")`` sweep mesh, one rank standing for one JAX device:
:func:`make_sweep_mesh` gives rank ``r = gi · node_width + ni`` (the
mesh's row-major device order) the scenario block ``gi`` of ``G /
grid_width`` scenarios and the row block ``ni`` of ``N / node_width``
rows.  The ranks that share ``gi`` form the *node subgroup*, a
:class:`FederationMesh` that carries the gossip collectives; the ranks
that share ``ni`` form the *grid subgroup*, which only gathers results:
no gossip collective crosses scenarios.  One process (no group) is the
``(1, 1)`` mesh and runs no collective.

Gossip data-parallelism (``core/gossip_dp.py``) lays the ranks out as
JAX's ``(node, data, model)`` mesh, or ``(pod, node, data, model)``
across pods: :func:`make_gossip_dp_mesh` gives rank r the row-major
coordinates of r, and the ranks that share every coordinate except the
node axes form a node subgroup, whose group ranks ascend with the node
index (``pod · per_pod + node`` for the compound axis).

The LM zoo's production meshes, :func:`make_production_mesh` (16 data
x 16 model, or 2 pods x 16 x 16) and :func:`make_test_mesh`, are
DTensor ``DeviceMesh``es with JAX's shapes and axis names over the
default group's ranks.  The multi-pod dry run (``launch/dryrun.py``)
builds them inside :func:`fake_world`, a process group of W fake ranks
in this one process (``torch.distributed``'s ``"fake"`` backend, whose
collectives move nothing), where JAX forces 512 host devices.  Their
device type is ``"cpu"``: a DTensor reports it as its device, so every
kernel wrapper of ``kernels/ops.py`` takes its plain twin there, never
a CUDA kernel on a fake tensor.

The plan-resolution policies ``choose_gossip_impl`` and
``choose_gossip_repr`` live in ``core.gossip_plan`` and are re-exported
here, as the JAX package's ``launch.mesh`` does.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, ClassVar

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class FederationMesh:
    """The calling rank's place in the federation: its process group
    (None on one process), the width W, its rank, and N."""

    group: Any
    width: int
    rank: int
    num_nodes: int

    axis_names: ClassVar[tuple[str, ...]] = ("node",)

    @property
    def rows(self) -> slice:
        """This rank's contiguous block of global federation rows."""
        k = self.num_nodes // self.width
        return slice(self.rank * k, (self.rank + 1) * k)

    def peer(self, rank: int) -> int:
        """The global rank of group rank ``rank`` modulo the width (the
        ring's neighbours)."""
        return dist.get_global_rank(self.group, rank % self.width)


def make_federation_mesh(num_nodes: int, *, device=None) -> FederationMesh:
    """The federation mesh of the default process group, or the
    one-process mesh when none is initialized.  With ``device``, the
    group's backend must be the device's: ``nccl`` for CUDA, ``gloo``
    for the CPU (no path falls back from one to the other)."""
    if not (dist.is_available() and dist.is_initialized()):
        return FederationMesh(None, 1, 0, num_nodes)
    group = dist.group.WORLD
    width = dist.get_world_size(group)
    if num_nodes % width:
        raise ValueError(
            f"the federation's N={num_nodes} nodes do not split over W={width} ranks: "
            f"each rank holds N / W contiguous rows, so W must divide N")
    _check_backend(group, device)
    return FederationMesh(group, width, dist.get_rank(group), num_nodes)


def _check_backend(group, device) -> None:
    """The group's backend must be the device's: ``nccl`` for CUDA,
    ``gloo`` for the CPU."""
    if device is None:
        return
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    backend = dist.get_backend(group)
    if backend != want:
        raise ValueError(f"a {torch.device(device).type} trainer needs a {want!r} process "
                         f"group, got {backend!r}")


@dataclass(frozen=True)
class SweepMesh:
    """The calling rank's place on the ``(grid_width, node_width)`` sweep
    mesh: its node subgroup ``node`` (a :class:`FederationMesh` of the
    ``node_width`` ranks that share its scenario block), its grid
    subgroup ``grid_group`` (the ``grid_width`` ranks that share its row
    block; None on one process) and its scenario block ``grid_index``."""

    grid_width: int
    node_width: int
    grid_index: int
    node: FederationMesh
    grid_group: Any

    axis_names: ClassVar[tuple[str, ...]] = ("grid", "node")

    @property
    def shape(self) -> dict[str, int]:
        return {"grid": self.grid_width, "node": self.node_width}

    @property
    def num_nodes(self) -> int:
        return self.node.num_nodes

    @property
    def rows(self) -> slice:
        """This rank's contiguous block of global federation rows, the
        same in each of its scenarios."""
        return self.node.rows

    def scenarios(self, num_scenarios: int) -> slice:
        """This rank's contiguous block of the grid's ``num_scenarios``
        scenarios."""
        per = num_scenarios // self.grid_width
        return slice(self.grid_index * per, (self.grid_index + 1) * per)


def _sweep_mesh_widths(num_scenarios: int, num_nodes: int, avail: int) -> tuple[int, int]:
    """(grid_width, node_width) for :func:`make_sweep_mesh`'s default
    search: both must divide their extents; maximize devices used, then
    prefer the wider node axis (the memory-scaled one).  The JAX
    package's search, unchanged."""
    best = (1, 1)
    for gw in (d for d in range(1, avail + 1) if num_scenarios % d == 0):
        for nw in (d for d in range(1, avail // gw + 1) if num_nodes % d == 0):
            if (gw * nw, nw) > (best[0] * best[1], best[1]):
                best = (gw, nw)
    return best


def make_sweep_mesh(num_scenarios: int, num_nodes: int, *, grid_width: int | None = None,
                    node_width: int | None = None, device=None) -> SweepMesh:
    """The sweep mesh of the default process group's W ranks (one
    process: the ``(1, 1)`` mesh, no group).  The widths default to
    JAX's search over ``avail = W`` ranks; both must divide their
    extents, and ``grid_width · node_width`` must be W, since a rank
    outside the mesh would have nothing to train.  Every rank creates
    every subgroup (``dist.new_group``) in the same order: the node
    subgroups by ``gi``, then the grid subgroups by ``ni``.  With
    ``device``, the group's backend must be the device's, as for
    :func:`make_federation_mesh`."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if grid_width is None or node_width is None:
        grid_width, node_width = _sweep_mesh_widths(num_scenarios, num_nodes, world)
    if num_scenarios % grid_width or num_nodes % node_width:
        raise ValueError(
            f"sweep mesh widths must divide the grid: G={num_scenarios} % "
            f"grid_width={grid_width} and N={num_nodes} % node_width={node_width} must both be 0")
    if grid_width * node_width != world:
        raise ValueError(
            f"the sweep mesh ({grid_width} x {node_width}) for G={num_scenarios} scenarios and "
            f"N={num_nodes} nodes does not cover the W={world} ranks: each rank holds one "
            f"(G / grid_width, N / node_width) block, so grid_width * node_width must be W")
    if not grouped:
        return SweepMesh(1, 1, 0, FederationMesh(None, 1, 0, num_nodes), None)
    _check_backend(dist.group.WORLD, device)
    rank = dist.get_rank()
    gi, ni = divmod(rank, node_width)
    node_groups = [dist.new_group([g * node_width + i for i in range(node_width)])
                   for g in range(grid_width)]
    grid_groups = [dist.new_group([g * node_width + i for g in range(grid_width)])
                   for i in range(node_width)]
    node = FederationMesh(node_groups[gi], node_width, ni, num_nodes)
    return SweepMesh(grid_width, node_width, gi, node, grid_groups[ni])


@dataclass(frozen=True)
class GossipDPMesh:
    """The calling rank's place on the gossip-DP layout: the axes and
    their widths (row-major, JAX's device order), its coordinate on each
    axis, and its node subgroups, one for each tuple of node axes a mix
    may run over (``("node",)``, and ``("pod", "node")`` with pods; None
    on one process)."""

    axis_names: tuple[str, ...]
    widths: tuple[int, ...]
    coords: tuple[int, ...]
    groups: dict

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.widths))

    def node_group(self, node_axes: tuple[str, ...]):
        """The process group of the ranks that share every coordinate of
        this rank except those on ``node_axes``."""
        if tuple(node_axes) not in self.groups:
            raise ValueError(f"no node subgroup over {tuple(node_axes)}; the mesh has "
                             f"{tuple(self.groups)}")
        return self.groups[tuple(node_axes)]

    def node_index(self, node_axes: tuple[str, ...]) -> int:
        """This rank's node id along the (possibly compound) node axes,
        row-major: ``pod · per_pod + node`` for ``("pod", "node")``."""
        shape, coord = self.shape, dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in node_axes:
            idx = idx * shape[a] + coord[a]
        return idx


def make_gossip_dp_mesh(*, nodes: int = 4, multi_pod: bool = False, data: int | None = None,
                        model: int | None = None, device=None) -> GossipDPMesh:
    """The gossip-DP layout of the default process group's W ranks
    (JAX's ``make_gossip_dp_mesh``): ``(node, data, model)``, or with
    ``multi_pod`` ``(pod, node, data, model)`` with 2 pods of
    ``max(nodes // 2, 1)`` nodes each, rank r at the row-major
    coordinates of r, one rank standing for one JAX device.  ``data``
    and ``model`` default to JAX's 16-wide production split (``16 //
    nodes a pod`` and 16, so W = 256 a pod); the widths' product must
    be W.  Every rank creates every node subgroup (``dist.new_group``)
    in the same order.  With ``device``, the group's backend must be
    the device's, as for :func:`make_federation_mesh`."""
    per_pod = max(nodes // 2, 1) if multi_pod else nodes
    data = 16 // per_pod if data is None else data
    model = 16 if model is None else model
    if multi_pod:
        names, widths = ("pod", "node", "data", "model"), (2, per_pod, data, model)
        node_axes = [("node",), ("pod", "node")]
    else:
        names, widths = ("node", "data", "model"), (nodes, data, model)
        node_axes = [("node",)]
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    if math.prod(widths) != world:
        raise ValueError(f"the gossip-DP mesh {dict(zip(names, widths))} needs "
                         f"{math.prod(widths)} ranks, not W={world}: one rank a device")
    rank = dist.get_rank() if grouped else 0
    coords = tuple(int(c) for c in np.unravel_index(rank, widths))
    if not grouped:
        return GossipDPMesh(names, widths, coords, {axes: None for axes in node_axes})
    _check_backend(dist.group.WORLD, device)
    groups = {}
    for axes in node_axes:
        others = [i for i, a in enumerate(names) if a not in axes]
        mine = None
        for fixed in np.ndindex(*(widths[i] for i in others)):
            members = [r for r in range(world)
                       if tuple(np.unravel_index(r, widths)[i] for i in others) == fixed]
            group = dist.new_group(members)
            if rank in members:
                mine = group
        groups[axes] = mine
    return GossipDPMesh(names, widths, coords, groups)


@contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A process group of ``world_size`` fake ranks, this process rank
    ``rank`` (``torch.distributed``'s ``"fake"`` backend over its ``FakeStore``:
    every collective returns at once and moves nothing).  Refuses when a
    process group already exists (a real multi-rank run, or a fake world
    not left), and destroys the group on exit, whatever happened inside:
    ``make_federation_mesh`` reads an initialized group as more than one
    process."""
    if dist.is_initialized():
        raise RuntimeError("a process group already exists; a fake world needs a process "
                           "without one (destroy it first)")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(shape: tuple[int, ...], names: tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape) != world:
        raise ValueError(f"the mesh {dict(zip(names, shape))} needs {math.prod(shape)} ranks, "
                         f"not W={world}: one rank a device")
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: 256 ranks (16 data x 16 model).  Multi-pod: 2 pods of
    256 (pod x data x model).  A ``DeviceMesh`` over the default group,
    whose world must be 256 or 512 ranks (:func:`fake_world`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _device_mesh(shape, axes)


def flatten_data_axes(mesh):
    """The multi-pod mesh with its pod and data dims flattened into one
    dim named ``"pod+data"`` (pod-major, the same ranks in the same
    order), the mesh unchanged without a pod dim.  Every spec of the
    zoo shards pod and data together (``arch.sharding.data_axes``), and
    on three mesh dims DTensor's sharding propagation enumerates many
    times more strategies: the dry run traces on this two-dim view."""
    names = mesh.mesh_dim_names
    if "pod" not in names:
        return mesh
    widths = dict(zip(names, mesh.shape))
    return _device_mesh((widths["pod"] * widths["data"], widths["model"]), ("pod+data", "model"))


def make_test_mesh(devices: int | None = None):
    """A small ``("data", "model")`` mesh over the default group's ranks
    (``devices`` of them, by default the world): (n // 2, 2) from 4
    ranks, else (n, 1)."""
    n = devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if n >= 4:
        return _device_mesh((n // 2, 2), ("data", "model"))
    return _device_mesh((n, 1), ("data", "model"))


# the auto-knob policies are plan-resolution policies and live with the
# plan in core.gossip_plan; re-exported here as the JAX package does
from repro_torch.core.gossip_plan import (  # noqa: E402,F401
    DEFAULT_GATHER_BUDGET_BYTES,
    SPARSE_GOSSIP_FACTOR,
    choose_gossip_impl,
    choose_gossip_repr,
)
