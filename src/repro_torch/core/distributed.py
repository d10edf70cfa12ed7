"""Distributed gossip: the paper's communication step over
``torch.distributed`` ranks (the counterpart of
``repro.core.distributed``).

The federation's node axis is split over the ranks of a
:class:`~repro_torch.launch.mesh.FederationMesh`: rank r holds the
contiguous block of ``k = N / W`` rows ``mesh.rows`` of the flat
``(N, D)`` parameter matrix, and each shard body below runs on that
``(k, D)`` block with explicit collectives:

  * ring      — :func:`ring_gossip_shard`: two one-row halo exchanges
                (``batch_isend_irecv``), O(D) a link;
  * dense     — the general row-stochastic mix, three schedules behind
                ``impl=``: ``"allgather"`` (:func:`general_gossip_shard`:
                ``all_gather_into_tensor``, then this rank's rows of the
                matrix against the gathered ``(N, D)``), ``"psum"``
                (:func:`psum_gossip_shard`: this rank's column block
                against its own rows, then ``reduce_scatter_tensor``
                with SUM, so no rank holds the gathered ``(N, D)``) and
                ``"masked"`` (the allgather schedule; the trainer adds
                the secure-aggregation term of ``core.secure_agg``
                outside the collective);
  * sparse    — the (N, B+1) neighbor table: ``"allgather"``
                (:func:`sparse_gossip_shard`: the same all-gather, then
                each row gathers its B+1 entries) and ``"gather"``
                (:func:`gather_tables_gossip_shard`: W-1 ring rotations
                of the row block, fp32 accumulation of the in-block
                entries, never an ``(N, D)``).

The mixing operator and the activity vector are global on every rank
(every rank builds the round's operator from the same draws); the
wrappers slice this rank's rows or columns of them.  Inactive rows are
a ``torch.where`` select, bitwise the old rows.

At W = 1 every body runs the same torch op on the same operands as the
tree mixer (``core.gossip``): the all-gather and the reduce-scatter of
a one-rank group are copies, and without a group no collective runs at
all.  So a one-rank sharded run is bitwise the tree mixer's, and with W
> 1 the results differ from it only by the summation order (psum,
gather) of fp32 sums.

The grid-batched forms serve the swept-sharded engine on a
:class:`~repro_torch.launch.mesh.SweepMesh`: picked, as in the JAX
package, for a 3-D operator on a sweep mesh or by ``grid_axis="grid"``,
they take the rank's ``(Gb, k, D)`` block (or its flat ``(Gb·k, D)``
rows) of its ``Gb`` scenarios and their global ``(Gb, N, N)`` matrices
or ``(Gb, N, B+1)`` tables, and run the schedule over the mesh's node
subgroup with one collective a round for the whole block (one
all-gather of the block, reordered to ``(Gb, N, D)``; one
reduce-scatter; one ring transfer a step).  No collective crosses the
grid.  At node width 1 each runs the tree sweep's torch op
(``GossipPlan.sweep_gossip``) on the same operands, so a ``(1, 1)``
sweep is bitwise the tree sweep.

The JAX package contracts these with ``jnp`` einsums and collectives
and calls no Pallas kernel on its sharded path; the bodies here are
plain PyTorch, like the tree mixer.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.gossip import gossip_mix_sparse_tree

# interchangeable schedules for the sharded mix (the JAX package's)
GOSSIP_IMPLS = ("allgather", "psum", "masked", "gather")

# mixing-operator representations: dense (N, N) matrix vs (N, B+1) table
GOSSIP_REPRS = ("dense", "sparse")

def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``(k, ...)`` block of a per-row tensor, in rank
    order, as the global ``(N, ...)``."""
    if mesh.group is None:
        return x
    out = x.new_empty((mesh.width * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out


def all_gather_grid(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every node rank's ``(Gb, k, ...)`` block of a grid block, in one
    all-gather, as the ``(Gb, N, ...)`` global rows of each scenario."""
    if mesh.group is None:
        return x
    out = x.new_empty((mesh.width * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.group)
    return out.view(mesh.width, *x.shape).transpose(0, 1).reshape(x.shape[0], -1,
                                                                  *x.shape[2:])


def all_gather_scenarios(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every grid rank's ``(Gb, ...)`` block of per-scenario results, in
    one all-gather over the sweep mesh's grid subgroup, as ``(G, ...)``
    in scenario order (one process: ``x``)."""
    if mesh.grid_group is None:
        return x
    out = x.new_empty((mesh.grid_width * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.grid_group)
    return out


def _reduce_scatter_grid(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over the node ranks of ``x`` (Gb, N, ...), this rank's
    ``(Gb, k, ...)`` rows of each scenario, in one reduce-scatter."""
    if mesh.group is None:
        return x
    gb, n = x.shape[:2]
    k = n // mesh.width
    send = x.view(gb, mesh.width, k, *x.shape[2:]).transpose(0, 1).reshape(
        mesh.width * gb, k, *x.shape[2:])
    out = x.new_empty((gb, k) + tuple(x.shape[2:]))
    dist.reduce_scatter_tensor(out, send, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def _reduce_scatter_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum over ranks of ``x`` (N, ...), this rank's ``(k, ...)``
    rows of it."""
    if mesh.group is None:
        return x
    out = x.new_empty((x.shape[0] // mesh.width,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x.contiguous(), op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over the ranks (in place, on every rank)."""
    if mesh.group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def _exchange(sends: list[tuple[torch.Tensor, int]], recvs: list[tuple[torch.Tensor, int]],
              mesh) -> None:
    """One batch of point-to-point transfers: ``sends`` (tensor, group
    rank) and ``recvs`` (buffer, group rank); the i-th send and receive
    carry tag i, so two transfers with one peer (two shards) match."""
    ops = [dist.P2POp(dist.isend, t.contiguous(), mesh.peer(r), mesh.group, tag=i)
           for i, (t, r) in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, t, mesh.peer(r), mesh.group, tag=i)
            for i, (t, r) in enumerate(recvs)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()


def ring_gossip_shard(w: torch.Tensor, active: torch.Tensor, mesh) -> torch.Tensor:
    """Ring mix of this rank's ``(k, D)`` block ``w`` and its ``(k, 1)``
    activity flags: inactive rows keep their row; an active row averages
    itself with its active ring neighbours ``i±1``.

    Inside the block the neighbours are the block's own rows; only the
    boundary rows talk to the adjacent ranks, one row each way (sending
    whole blocks would hand row i the params of row ``i±k``).  Flags and
    params travel as one ``(1, D+1)`` row.  At W = 1 the wrap-around is
    the block's own last and first rows."""
    v = torch.cat([w, active.to(w.dtype)], dim=1)
    if mesh.width == 1:
        prev_last, next_first = v[-1:], v[:1]
    else:
        prev_last, next_first = torch.empty_like(v[:1]), torch.empty_like(v[:1])
        _exchange([(v[-1:], mesh.rank + 1), (v[:1], mesh.rank - 1)],
                  [(prev_last, mesh.rank - 1), (next_first, mesh.rank + 1)], mesh)
    v_prev = torch.cat([prev_last, v[:-1]])
    v_next = torch.cat([v[1:], next_first])
    w_prev, a_prev = v_prev[:, :-1], v_prev[:, -1:]
    w_next, a_next = v_next[:, :-1], v_next[:, -1:]
    mixed = (w + a_prev * w_prev + a_next * w_next) / (1.0 + a_prev + a_next)
    return torch.where(active > 0, mixed, w)


def general_gossip_shard(w: torch.Tensor, mix_rows: torch.Tensor, mesh) -> torch.Tensor:
    """Dense mix, allgather schedule: the node axis of ``w`` (k, D) is
    all-gathered and this rank's ``(k, N)`` rows of the mixing matrix
    contract it, in fp32."""
    w_all = all_gather_rows(w, mesh)
    return mix_rows.to(torch.float32) @ w_all


def psum_gossip_shard(w: torch.Tensor, mix_cols: torch.Tensor, mesh) -> torch.Tensor:
    """Dense mix, psum schedule: this rank's ``(N, k)`` column block of
    the matrix contracts its own rows into a contribution to every
    output row, and a reduce-scatter sums the contributions, leaving
    each rank its own rows.  No rank holds the gathered ``(N, D)``."""
    contrib = mix_cols.to(torch.float32) @ w
    return _reduce_scatter_rows(contrib, mesh)


def sparse_gossip_shard(w: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                        mesh) -> torch.Tensor:
    """Sparse mix, allgather schedule: the node axis is all-gathered
    and each of this rank's rows gathers its B+1 table entries (``idx``,
    ``wgt``: this rank's ``(k, B+1)`` table rows)."""
    w_all = all_gather_rows(w, mesh)
    return torch.einsum("kb,kbd->kd", wgt.to(torch.float32), w_all[idx.long()])


def gather_tables_gossip_shard(w: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                               mesh) -> torch.Tensor:
    """Sparse mix, gather-table schedule: the row block ring-rotates
    through every rank in W - 1 steps (each sends its block to rank - 1
    and receives rank + 1's), so at step t this rank holds the rows of
    rank ``(rank + t) % W`` and contracts exactly the table entries that
    reference them.  Each (row, slot) lands in one step, and the fp32
    step sums add up to the whole B+1 contraction.  Two row blocks are
    resident, resident and in flight: O(N/W · D), no gathered (N, D).
    Leading dims (a sweep's grid block ``(Gb, k, D)`` with its
    ``(Gb, k, B+1)`` table rows) batch through, one transfer a step for
    the whole block."""
    k = w.shape[-2]
    lead = w.shape[0] if w.dim() == 3 else 1
    block = w.to(torch.float32).reshape(lead, k, -1)
    idx3 = idx.long().reshape(lead, k, -1)
    wgt32 = wgt.to(torch.float32).reshape(lead, k, -1)
    offset = (torch.arange(lead, device=idx.device) * k)[:, None, None]
    acc = None
    for t in range(mesh.width):
        src = (mesh.rank + t) % mesh.width     # whose rows `block` holds now
        local = idx3 - src * k
        in_block = (local >= 0) & (local < k)
        rows = (torch.where(in_block, local, 0) + offset).reshape(lead * k, -1)
        term = torch.einsum("nb,nbd->nd", torch.where(in_block, wgt32, 0.0).reshape(lead * k, -1),
                            block.reshape(lead * k, -1)[rows])
        acc = term if acc is None else acc + term
        if t + 1 < mesh.width:
            incoming = torch.empty_like(block)
            _exchange([(block, mesh.rank - 1)], [(incoming, mesh.rank + 1)], mesh)
            block = incoming
    return acc.reshape(w.shape)


# wire-schedule registry for the dense sharded mix: impl -> (shard body,
# which block of the matrix a rank contracts).  "masked" aliases the
# allgather entry: secure aggregation adds its exact-zero term after the
# mix, so its wire is the gathered-rows one.
_DENSE_WIRE_SCHEDULES = {
    "allgather": (general_gossip_shard, "rows"),
    "masked": (general_gossip_shard, "rows"),
    "psum": (psum_gossip_shard, "cols"),
}


def process_row_slice(mesh, global_shape: tuple) -> slice:
    """The contiguous block of axis-0 global rows this rank holds under
    ``mesh``; a width that leaves a rank without its whole share fails
    here, naming the shape and the width."""
    n = global_shape[0]
    if n != mesh.num_nodes or n % mesh.width:
        raise ValueError(f"rank {mesh.rank} of {mesh.width} owns no whole block of "
                         f"{n} rows (the mesh splits {mesh.num_nodes})")
    return mesh.rows


def addressable_node_rows(mesh, num_nodes: int) -> slice:
    """The ``[lo, hi)`` interval of global federation rows this rank
    holds (every row on one process)."""
    return process_row_slice(mesh, (num_nodes,))


def _default_federation_mesh(num_nodes: int, device=None):
    """The mesh of the default process group (one process: no group)."""
    from repro_torch.launch.mesh import make_federation_mesh

    return make_federation_mesh(num_nodes, device=device)


def _check(lead: int, n: int, what: str) -> None:
    if lead != n:
        raise ValueError(f"{what} leading dim {lead} != the mesh's N={n}")


def _keep_inactive(out: torch.Tensor, w: torch.Tensor, active, rows: slice) -> torch.Tensor:
    """Inactive rows as bitwise copies of ``w``; ``active`` is the global
    (N,) flags, or a grid block's (Gb, N)."""
    if active is None:
        return out
    return torch.where(active[..., rows].reshape(w.shape[:-1] + (1,)) > 0, out, w)


def _node_mesh(mesh):
    """The mesh the gossip collectives run over: a sweep mesh's node
    subgroup, or the federation mesh itself."""
    return mesh.node if mesh.axis_names == ("grid", "node") else mesh


def _is_grid(op: torch.Tensor, mesh, grid_axis, what: str, shapes: tuple[str, str]) -> bool:
    """Whether a call is grid-batched (``grid_axis="grid"``, or a 3-D
    operator on a sweep mesh), with the operator's rank checked against
    it in the JAX package's words."""
    if grid_axis not in (None, "grid"):
        raise ValueError(f"grid_axis must be None or 'grid', got {grid_axis!r}")
    grid = grid_axis is not None or (op.dim() == 3 and mesh.axis_names == ("grid", "node"))
    want = 3 if grid else 2
    if op.dim() != want:
        raise ValueError(f"{what} must be {want}-D {shapes[grid]} for grid_axis={grid_axis!r}, "
                         f"got shape {tuple(op.shape)}")
    return grid


def _grid_block(w: torch.Tensor, op: torch.Tensor, node, what: str) -> torch.Tensor:
    """The rank's block of a grid call as ``(Gb, k, D)``, given as that
    or as its flat ``(Gb·k, D)`` rows; its scenario count must be the
    operator's leading dim."""
    _check(op.shape[1], node.num_nodes, what)
    k = node.num_nodes // node.width
    lead = w.shape[0] if w.dim() == 3 else w.shape[0] / k
    if lead != op.shape[0] or (w.dim() == 3 and w.shape[1] != k):
        raise ValueError(f"stacked leading dim {lead:g} != {what} leading dim {op.shape[0]} "
                         f"(block {tuple(w.shape)} of {k} rows a scenario, {what} "
                         f"{tuple(op.shape)})")
    return w.reshape(op.shape[0], k, -1)


def sharded_gossip_mix(w: torch.Tensor, mix: torch.Tensor, active: torch.Tensor | None = None,
                       *, mesh=None, impl: str = "allgather", grid_axis=None) -> torch.Tensor:
    """Rank-parallel dense gossip: ``w`` is this rank's ``(k, D)`` rows,
    ``mix`` the global (N, N) matrix (and ``active`` the global (N,)
    flags, for a bitwise where-select of inactive rows; identity rows
    already keep them for finite data).  ``impl`` picks the schedule:
    ``"allgather"``/``"masked"`` (this rank's matrix rows against the
    gathered federation) or ``"psum"`` (its column block, then a
    reduce-scatter).  Returns this rank's ``(k, D)`` mixed rows.

    Grid-batched (a (Gb, N, N) ``mix`` on a sweep mesh, or
    ``grid_axis="grid"``): ``w`` is the rank's ``(Gb, k, D)`` block (or
    its ``(Gb·k, D)`` rows) and ``active`` (Gb, N); the result has
    ``w``'s shape."""
    if impl not in _DENSE_WIRE_SCHEDULES:
        raise ValueError(f"impl {impl!r} not in {tuple(_DENSE_WIRE_SCHEDULES)} (dense wire "
                         f"schedules; 'gather' is sparse-only -- sharded_gossip_mix_gather)")
    mesh = mesh or _default_federation_mesh(mix.shape[-1])
    grid = _is_grid(mix, mesh, grid_axis, "mixing matrix", ("(N, N)", "(G, N, N)"))
    node = _node_mesh(mesh)
    body, block = _DENSE_WIRE_SCHEDULES[impl]
    rows = node.rows
    if not grid:
        _check(mix.shape[0], node.num_nodes, "mixing-matrix")
        out = body(w, mix[:, rows] if block == "cols" else mix[rows], node)
        return _keep_inactive(out, w, active, rows)
    w3 = _grid_block(w, mix, node, "mixing-matrix")
    if block == "cols":
        out = _reduce_scatter_grid(mix[:, :, rows].to(torch.float32) @ w3, node)
    else:
        out = mix[:, rows].to(torch.float32) @ all_gather_grid(w3, node)
    return _keep_inactive(out.reshape(w.shape), w, active, rows)


def _table_call(w, idx, wgt, mesh, grid_axis):
    """The shared front of the two table schedules: the checks, the node
    mesh, the rows, and the block as ``(Gb, k, D)`` on a grid call
    (else None)."""
    if idx.shape != wgt.shape:
        raise ValueError(f"idx {tuple(idx.shape)} != wgt {tuple(wgt.shape)}")
    mesh = mesh or _default_federation_mesh(idx.shape[-2])
    grid = _is_grid(idx, mesh, grid_axis, "neighbor table", ("(N, B+1)", "(G, N, B+1)"))
    node = _node_mesh(mesh)
    if not grid:
        _check(idx.shape[0], node.num_nodes, "neighbor-table")
        return node, None
    return node, _grid_block(w, idx, node, "neighbor-table")


def sharded_gossip_mix_sparse(w: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                              active: torch.Tensor | None = None, *, mesh=None,
                              grid_axis=None) -> torch.Tensor:
    """Rank-parallel gossip from the global (N, B+1) neighbor table
    ``(idx, wgt)``: the allgather schedule, then each of this rank's
    ``(k, D)`` rows gathers its B+1 entries.  Grid-batched as
    :func:`sharded_gossip_mix` (a (Gb, N, B+1) table): the block is
    gathered once to ``(Gb·N, D)`` and each row gathers through its
    table row offset by its scenario's ``g·N``, the tree sweep's
    gather."""
    node, w3 = _table_call(w, idx, wgt, mesh, grid_axis)
    rows = node.rows
    if w3 is None:
        return _keep_inactive(sparse_gossip_shard(w, idx[rows], wgt[rows], node), w, active, rows)
    gb, n = idx.shape[:2]
    w_all = all_gather_grid(w3, node).reshape(gb * n, -1)
    offset = (torch.arange(gb, dtype=idx.dtype, device=idx.device) * n)[:, None, None]
    mine = (idx[:, rows] + offset).reshape(-1, idx.shape[-1])
    out = gossip_mix_sparse_tree(w_all, mine, wgt[:, rows].reshape(-1, idx.shape[-1]))
    return _keep_inactive(out.reshape(w.shape), w, active, rows)


def sharded_gossip_mix_gather(w: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                              active: torch.Tensor | None = None, *, mesh=None,
                              grid_axis=None) -> torch.Tensor:
    """Rank-parallel gossip from the neighbor table on the gather-table
    schedule (``gossip_impl="gather"``): the same contract as
    :func:`sharded_gossip_mix_sparse`, and no rank ever holds the
    gathered (N, D) federation (grid-batched: no ``(Gb, N, D)``)."""
    node, w3 = _table_call(w, idx, wgt, mesh, grid_axis)
    rows = node.rows
    if w3 is None:
        out = gather_tables_gossip_shard(w, idx[rows], wgt[rows], node)
    else:
        out = gather_tables_gossip_shard(w3, idx[:, rows], wgt[:, rows], node).reshape(w.shape)
    return _keep_inactive(out, w, active, rows)


def make_sharded_gossip(mesh, topology: str, *, gossip_impl: str = "allgather"):
    """``gossip(w, mix_or_active)`` on ``mesh``, with ``w`` this rank's
    ``(k, D)`` rows: the ring's two halo exchanges given the global (N,)
    activity flags when ``topology == "ring"``, else
    :func:`sharded_gossip_mix` of the global (N, N) matrix on the
    ``gossip_impl`` schedule."""
    if topology == "ring":
        def gossip(w: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
            return ring_gossip_shard(w, active[mesh.rows, None], mesh)
        return gossip

    def gossip(w: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
        return sharded_gossip_mix(w, mix, mesh=mesh, impl=gossip_impl)
    return gossip
