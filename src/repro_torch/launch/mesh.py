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

The plan-resolution policies ``choose_gossip_impl`` and
``choose_gossip_repr`` live in ``core.gossip_plan`` and are re-exported
here, as the JAX package's ``launch.mesh`` does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

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
    if device is not None:
        want = "nccl" if torch.device(device).type == "cuda" else "gloo"
        backend = dist.get_backend(group)
        if backend != want:
            raise ValueError(f"a {torch.device(device).type} trainer needs a {want!r} process "
                             f"group, got {backend!r}")
    return FederationMesh(group, width, dist.get_rank(group), num_nodes)


# the auto-knob policies are plan-resolution policies and live with the
# plan in core.gossip_plan; re-exported here as the JAX package does
from repro_torch.core.gossip_plan import (  # noqa: E402,F401
    DEFAULT_GATHER_BUDGET_BYTES,
    SPARSE_GOSSIP_FACTOR,
    choose_gossip_impl,
    choose_gossip_repr,
)
