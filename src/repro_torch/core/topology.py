"""Communication topologies (paper §3.3) as adjacency and mixing
matrices, and their sparse neighbor-table twin (the counterpart of
``repro.core.topology``).

A round's row-stochastic mixing matrix (Algorithm 1 lines 7-9) is

    M[n] = uniform over ({n} ∪ active neighbours of n, capped at B)  if n active
    M[n] = e_n (identity row: keeps its stale model)                   if n inactive

and the cap keeps the B LOWEST-index active neighbours.  The neighbor
table holds the same rows as ``(idx, wgt)`` of shape (N, B+1): slot 0 is
self, slots 1.. the kept neighbours in ascending order, padding slots
point at self with weight 0.  Everything here is comparisons, exact
sums of 0/1 values and one IEEE division, so given the same activity
mask and random scores the port's matrices and tables equal the JAX
package's bitwise, and :func:`densify_neighbor_table` of a table equals
:func:`mixing_matrix` bitwise.

The round builders (:func:`random_adjacency`, :func:`mixing_matrix`,
:func:`neighbor_table`) also take a leading scenario axis G, as the
sweep engine stacks them: every operation is per row, so scenario g of
a stacked call equals the unstacked call on scenario g bitwise
(:func:`mixing_matrix_stacked`, :func:`stacked_neighbor_table`).
"""
from __future__ import annotations

import numpy as np
import torch


def ring_adjacency(n: int) -> torch.Tensor:
    """Each node talks to its two ring neighbours."""
    a = np.zeros((n, n), np.float32)
    for i in range(n):
        a[i, (i + 1) % n] = 1
        a[i, (i - 1) % n] = 1
    if n <= 2:
        np.fill_diagonal(a, 0)
    return torch.from_numpy(a)


def cluster_adjacency(n: int, cluster_size: int = 4) -> torch.Tensor:
    """Fully connected clusters on a ring; one bridge node links each
    cluster to the next (SWIFT-style cluster-ring)."""
    a = np.zeros((n, n), np.float32)
    n_clusters = max(1, -(-n // cluster_size))
    for c in range(n_clusters):
        lo, hi = c * cluster_size, min((c + 1) * cluster_size, n)
        a[lo:hi, lo:hi] = 1
        for i in range(lo, hi):
            a[i, i] = 0
        nxt = ((c + 1) % n_clusters) * cluster_size
        if hi - 1 != nxt:
            a[hi - 1, nxt] = 1
            a[nxt, hi - 1] = 1
    return torch.from_numpy(a)


def star_adjacency(n: int) -> torch.Tensor:
    """FedAvg's topology: node 0 is the server."""
    a = np.zeros((n, n), np.float32)
    a[0, 1:] = 1
    a[1:, 0] = 1
    return torch.from_numpy(a)


def full_adjacency(n: int) -> torch.Tensor:
    return torch.ones((n, n)) - torch.eye(n)


def random_adjacency(scores: torch.Tensor, degree: int) -> torch.Tensor:
    """Time-varying random graph from a round's (..., N, N) uniform
    ``scores``: each node takes the ``degree`` top-scoring peers other
    than itself, then the graph is symmetrized."""
    n = scores.shape[-1]
    eye = torch.eye(n, device=scores.device)
    _, idx = torch.topk(scores - 2.0 * eye, degree, dim=-1)
    a = torch.zeros(scores.shape, device=scores.device)
    a.scatter_(-1, idx, 1.0)
    return torch.maximum(a, a.transpose(-1, -2))


def static_adjacency(topology: str, n: int, cluster_size: int = 4) -> torch.Tensor | None:
    """The fixed graph of a static topology; None for ``"random"``."""
    if topology == "ring":
        return ring_adjacency(n)
    if topology == "cluster":
        return cluster_adjacency(n, cluster_size)
    if topology == "star":
        return star_adjacency(n)
    if topology == "full":
        return full_adjacency(n)
    if topology == "random":
        return None
    raise KeyError(f"unknown topology {topology!r}")


def stacked_adjacency(topologies, n: int, cluster_size: int = 4
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sweep grid's graphs: ``(adjacency (G, N, N), resample (G,))``,
    one static adjacency per scenario, and ``resample`` 1 for a
    topology that draws its graph every round (``"random"``, which gets
    a zero placeholder here)."""
    adjs, flags = [], []
    for topo in topologies:
        static = static_adjacency(topo, n, cluster_size)
        adjs.append(torch.zeros((n, n)) if static is None else static)
        flags.append(1.0 if static is None else 0.0)
    return torch.stack(adjs), torch.tensor(flags)


def round_adjacency(
    topology: str, n: int, scores: torch.Tensor | None, comm_batch: int, cluster_size: int = 4
) -> torch.Tensor:
    """This round's adjacency: the static graph, or a random one drawn
    from ``scores``."""
    static = static_adjacency(topology, n, cluster_size)
    if static is not None:
        return static
    return random_adjacency(scores, min(comm_batch, n - 1))


def mixing_matrix(adjacency: torch.Tensor, active: torch.Tensor, comm_batch: int) -> torch.Tensor:
    """Algorithm 1 lines 7-9 as a row-stochastic (..., N, N) matrix from
    (..., N, N) adjacencies and (..., N) masks; see the module
    docstring.  The left-to-right cumulative count keeps the B
    lowest-index active neighbours of each row."""
    n = adjacency.shape[-1]
    act = active.to(torch.float32)
    neigh = adjacency * act[..., None, :]
    csum = torch.cumsum(neigh, dim=-1)
    neigh = neigh * (csum <= comm_batch)
    eye = torch.eye(n, device=adjacency.device)
    w = neigh + eye
    mix_active = w / torch.sum(w, dim=-1, keepdim=True)
    return act[..., :, None] * mix_active + (1 - act)[..., :, None] * eye


def mixing_matrix_stacked(adjacency: torch.Tensor, active: torch.Tensor,
                          comm_batch: int) -> torch.Tensor:
    """(G, N, N) adjacencies and (G, N) masks -> (G, N, N) matrices,
    scenario g bitwise ``mixing_matrix(adjacency[g], active[g], B)``."""
    return mixing_matrix(adjacency, active, comm_batch)


def neighbor_table_from_candidates(
    cand_idx: torch.Tensor, cand_valid: torch.Tensor, active: torch.Tensor, comm_batch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse mixing rows from per-node candidate lists (``cand_idx``
    (N, C) in ascending column order, ``cand_valid`` (..., N, C) masking
    padding) and (..., N) active masks: the :func:`mixing_matrix`
    semantics as an ``(idx int32, wgt f32)`` table of shape
    (..., N, min(B, C) + 1).

    The kept slots are compacted to the front by a top-k over minus
    their position; non-kept slots tie at -inf, and ``torch.topk``
    does not promise JAX's order among ties.  That cannot show: a
    non-kept slot gets weight 0, and every zero-weight slot's index is
    rewritten to self, as in the JAX package."""
    n, c = cand_idx.shape
    lead = active.shape[:-1]
    dev = cand_idx.device
    b = int(min(comm_batch, c))
    act = active.to(torch.float32)
    self_idx = torch.arange(n, dtype=torch.int32, device=dev)
    # each candidate's activity, per scenario of a stacked call
    act_cand = torch.gather(act, -1, cand_idx.long().reshape(-1).expand(*lead, n * c))
    avail = cand_valid.to(torch.float32) * act_cand.view(*lead, n, c)
    csum = torch.cumsum(avail, dim=-1)
    keep = avail * (csum <= comm_batch)
    denom = 1.0 + torch.sum(keep, dim=-1)
    cand = cand_idx.to(torch.int32).expand(*lead, n, c)
    if b > 0:
        position = torch.arange(c, dtype=torch.float32, device=dev)
        score = torch.where(keep > 0, -position, torch.tensor(-torch.inf, device=dev))
        _, pos = torch.topk(score, b, dim=-1)
        sel_keep = torch.gather(keep, -1, pos)
        sel_idx = torch.gather(cand, -1, pos)
        nb_wgt = act[..., None] * sel_keep / denom[..., None]
    else:
        sel_idx = torch.zeros((*lead, n, 0), dtype=torch.int32, device=dev)
        nb_wgt = torch.zeros((*lead, n, 0), device=dev)
    self_wgt = torch.where(act > 0, 1.0 / denom, torch.ones_like(denom))
    self_col = self_idx[:, None].expand(*lead, n, 1)
    idx = torch.cat([self_col, sel_idx], dim=-1)
    wgt = torch.cat([self_wgt[..., None], nb_wgt], dim=-1)
    idx = torch.where(wgt > 0, idx, self_idx[:, None])
    return idx, wgt


def neighbor_table(
    adjacency: torch.Tensor, active: torch.Tensor, comm_batch: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Sparse twin of :func:`mixing_matrix` from a dense (..., N, N)
    adjacency: ``densify_neighbor_table(*neighbor_table(a, act, B)) ==
    mixing_matrix(a, act, B)`` bitwise."""
    n = adjacency.shape[-1]
    cand_idx = torch.arange(n, dtype=torch.int32, device=adjacency.device).expand(n, n)
    return neighbor_table_from_candidates(cand_idx, adjacency.to(torch.float32), active, comm_batch)


def stacked_neighbor_table(adjacency: torch.Tensor, active: torch.Tensor,
                           comm_batch: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, N, N) adjacencies and (G, N) masks -> (G, N, B+1) tables,
    scenario g bitwise ``neighbor_table(adjacency[g], active[g], B)``."""
    return neighbor_table(adjacency, active, comm_batch)


def neighbor_candidates(
    topology: str, n: int, cluster_size: int = 4
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """Host-built static candidate lists ``(cand_idx, cand_valid)`` for
    :func:`neighbor_table_from_candidates`; None for ``"random"``.  The
    ring is built directly in O(N); the other static topologies pad each
    row's nonzero columns of :func:`static_adjacency` to the max degree."""
    if topology == "random":
        return None
    if topology == "ring":
        if n <= 1:
            return torch.zeros((n, 1), dtype=torch.int32), torch.zeros((n, 1))
        i = np.arange(n)
        if n == 2:
            cand = (1 - i)[:, None]
        else:
            cand = np.sort(np.stack([(i - 1) % n, (i + 1) % n], axis=1), axis=1)
        cand = torch.from_numpy(cand.astype(np.int32))
        return cand, torch.ones(cand.shape)
    adj = static_adjacency(topology, n, cluster_size).numpy()
    deg = adj.sum(axis=1).astype(int)
    c = max(1, int(deg.max()))
    cand = np.zeros((n, c), np.int32)
    valid = np.zeros((n, c), np.float32)
    for row in range(n):
        nz = np.nonzero(adj[row])[0]
        cand[row, : len(nz)] = nz
        valid[row, : len(nz)] = 1.0
    return torch.from_numpy(cand), torch.from_numpy(valid)


def densify_neighbor_table(idx: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Scatter a neighbor table back to the dense (N, N) mixing matrix.
    Padding slots add 0.0 onto the diagonal, which leaves the self
    weight bit-identical."""
    n = idx.shape[0]
    out = torch.zeros((n, n), device=wgt.device)
    return out.scatter_add_(1, idx.long(), wgt.to(torch.float32))


def spectral_gap(mix) -> float:
    """1 - |lambda_2| of a mixing matrix (numpy, float64): the gossip
    convergence-rate proxy the topology ablation reports."""
    lam = np.linalg.eigvals(np.asarray(mix, np.float64))
    lam = np.sort(np.abs(lam))[::-1]
    return float(1.0 - (lam[1] if len(lam) > 1 else 0.0))
