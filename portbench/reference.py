"""The plain reference: GluADFL's rounds (Algorithm 1 of the paper) in
plain PyTorch, written from the paper and the port's documented
semantics.  It imports nothing of ``jax``, ``repro`` or ``repro_torch``
and takes nothing the program made: it starts from the inputs the
benchmark made (:mod:`portbench.generator`) and works out every operator
again.

A round of G scenarios of N nodes, each node's params as leaves
(G·N, *shape):

  1. activity: the Bernoulli schedule (:func:`generator.active_mask`);
  2. graph: the scenario's static graph (ring; clusters of 4 joined in a
     ring by bridge nodes), or the round's random graph: each node's B
     top-scoring peers other than itself, symmetrized;
  3. mixing operator: an active node averages itself and its active
     neighbours, the B lowest-index ones, with equal weights; an inactive
     node keeps its row (the identity);
  4. gossip: the (N, N) operator times each leaf's (N, F) rows;
  5. local steps: the MSE gradient of the node's batch of windows at the
     PRE-mix params (later steps at the updated ones), Adam (bias-
     corrected m and v, ``mhat / (sqrt(vhat) + eps)``, a step count of
     each node's own) applied to the mixed params;
  6. inactive mask: inactive nodes keep their params and Adam state;
  7. loss: the active-weighted mean of the nodes' mean losses;
  8. population: the mean of a scenario's N rows; its val RMSE over the
     eval windows (normalised, or in mg/dL).

``precision="tf32"`` rounds every matmul's operands to TF32 (10 bits of
mantissa, to nearest even), in the forward and the backward: the
control, the nearest precision below the fp32 the configurations state.
``keep_batch`` trains on only the first that many windows of each batch:
the half-batch fault.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench.generator import LEAVES, Draws, Scenario, active_mask


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.contiguous().view(torch.int32)
    r = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return r.view(torch.float32)


class _Tf32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(to_tf32(a), to_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return (torch.matmul(g, to_tf32(b).transpose(-1, -2)),
                torch.matmul(to_tf32(a).transpose(-1, -2), g))


def matmul_of(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "tf32":
        return _Tf32Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def lstm(p: dict, x: torch.Tensor, mm=torch.matmul) -> torch.Tensor:
    """The paper's single-layer LSTM with a linear head: x (R, B, L) or
    (R, B, L, I) under row r's params ``p[k][r]`` -> (R, B).  Gates in
    the order i, f, g, o."""
    xs = x if x.dim() == 4 else x[..., None]
    rows, batch, steps, _ = xs.shape
    hsz = p["wh"].shape[1]
    h = xs.new_zeros((rows, batch, hsz))
    c = xs.new_zeros((rows, batch, hsz))
    for t in range(steps):
        z = mm(xs[:, :, t, :], p["wx"]) + mm(h, p["wh"]) + p["b"][:, None, :]
        i, f, g, o = z.split(hsz, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return (mm(h, p["w_out"]) + p["b_out"][:, None, :])[..., 0]


def static_graph(topology: str, n: int, cluster_size: int) -> np.ndarray:
    """The (N, N) adjacency of a static topology."""
    a = np.zeros((n, n), np.float32)
    if topology == "ring":
        for i in range(n):
            a[i, (i + 1) % n] = a[i, (i - 1) % n] = 1.0
        if n <= 2:
            np.fill_diagonal(a, 0.0)
        return a
    if topology == "cluster":
        k = max(1, -(-n // cluster_size))
        for c in range(k):
            lo, hi = c * cluster_size, min((c + 1) * cluster_size, n)
            a[lo:hi, lo:hi] = 1.0
            bridge = ((c + 1) % k) * cluster_size
            if hi - 1 != bridge:
                a[hi - 1, bridge] = a[bridge, hi - 1] = 1.0
        np.fill_diagonal(a, 0.0)
        return a
    raise ValueError(f"no static graph for {topology!r}")


def random_graph(scores: torch.Tensor, degree: int) -> torch.Tensor:
    """Each node's ``degree`` top-scoring peers other than itself, then
    symmetrized: (G, N, N) scores -> (G, N, N) adjacency."""
    n = scores.shape[-1]
    s = scores.masked_fill(torch.eye(n, dtype=torch.bool, device=scores.device), -1.0)
    top = s.argsort(dim=-1, descending=True)[..., :degree]
    a = torch.zeros_like(scores).scatter_(-1, top, 1.0)
    return torch.maximum(a, a.transpose(-1, -2))


def mixing(adj: torch.Tensor, active: torch.Tensor, comm_batch: int) -> torch.Tensor:
    """(G, N, N) row-stochastic operators: an active node over itself
    and its B lowest-index active neighbours, equal weights; an inactive
    node the identity row."""
    n = adj.shape[-1]
    eye = torch.eye(n, device=adj.device)
    nb = adj * active[:, None, :]
    nb = nb * (torch.cumsum(nb, dim=-1) <= comm_batch)
    w = nb + eye
    mix = w / w.sum(dim=-1, keepdim=True)
    act = active[:, :, None]
    return act * mix + (1.0 - act) * eye


@dataclass
class Setup:
    """What the reference needs of a cell: the federation's rule, the
    traffic's grid and optimizer, the data (the model's sizes are the
    params')."""

    comm_batch: int
    cluster_size: int
    grid: list[Scenario]
    local_steps: int
    lr: float
    b1: float
    b2: float
    eps: float
    x: torch.Tensor          # (N, M, L) training windows on the device
    y: torch.Tensor          # (N, M)
    val_x: torch.Tensor      # (V, L)
    val_y: torch.Tensor      # (V,) normalised targets
    units_scale: float = 1.0  # sd for mg/dL, 1 for normalised


@dataclass
class Readings:
    """The numbers a run is judged by, for G scenarios: each round's
    loss (G, R); each leaf's norm of the first gradient as the optimizer
    got it (G, leaves); each leaf's norm of the params' change over the
    R rounds (G, leaves); each population's val RMSE after round R (G,);
    the populations, flat (G, D), on the host."""

    loss: np.ndarray
    grad: np.ndarray
    change: np.ndarray
    val: np.ndarray
    pop: np.ndarray


def sq_norms(leaf: torch.Tensor, g: int) -> np.ndarray:
    """Each scenario's squared norm of a (G·N, ...) leaf, summed in
    float64 in blocks of rows."""
    rows = leaf.reshape(g, -1, leaf[0].numel())
    sums = [sum(block.double().square().sum() for block in rows[s].split(16)) for s in range(g)]
    return torch.stack(sums).cpu().numpy()


def leaf_norms(leaves: dict, g: int) -> np.ndarray:
    """(G, len(LEAVES)) norms of each scenario's rows of each leaf."""
    return np.sqrt(np.stack([sq_norms(leaves[k], g) for k in LEAVES], axis=1))


def change_norms(now: dict, start: dict, g: int) -> np.ndarray:
    return np.sqrt(np.stack([sq_norms(now[k] - start[k], g) for k in LEAVES], axis=1))


def val_rmse(pops: dict, setup: Setup, mm=torch.matmul, block: int = 65_536) -> np.ndarray:
    """Each of the G populations' RMSE over the eval windows, in the
    eval's units, the windows in blocks."""
    g = pops["wx"].shape[0]
    sq = torch.zeros(g, dtype=torch.float64, device=setup.val_x.device)
    for lo in range(0, setup.val_x.shape[0], block):
        vx = setup.val_x[lo:lo + block]
        pred = lstm(pops, vx[None].expand(g, *vx.shape), mm)
        err = (pred - setup.val_y[lo:lo + block]) * setup.units_scale
        sq += err.double().square().sum(dim=1)
    return torch.sqrt(sq / setup.val_x.shape[0]).cpu().numpy()


def follow(setup: Setup, init: dict, draws: Draws, rounds: int, *,
           precision: str = "fp32", keep_batch: int | None = None) -> Readings:
    """Train ``rounds`` rounds of every scenario from ``init`` (leaves
    (G·N, *shape)) on ``draws``' rounds; the readings after them."""
    mm = matmul_of(precision)
    g, n = len(setup.grid), setup.x.shape[0]
    dev = setup.x.device
    degree = min(setup.comm_batch, n - 1)
    static = torch.stack([torch.zeros((n, n)) if s.topology == "random" else
                          torch.from_numpy(static_graph(s.topology, n, setup.cluster_size))
                          for s in setup.grid]).to(dev)
    resample = torch.tensor([s.topology == "random" for s in setup.grid], device=dev)
    ratios = torch.tensor([s.inactive_ratio for s in setup.grid], dtype=torch.float32, device=dev)
    node = torch.arange(g * n, device=dev) % n
    params = {k: v.clone() for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in init.items()}
    v2 = {k: torch.zeros_like(v) for k, v in init.items()}
    step = torch.zeros(g * n, device=dev)
    losses, first_grad = [], None
    for _ in range(rounds):
        u, scores, idx = draws.next()
        act = active_mask(u, ratios)
        adj = static
        if scores is not None:
            adj = torch.where(resample[:, None, None], random_graph(scores, degree), static)
        op = mixing(adj, act, setup.comm_batch)
        flat_act = act.reshape(-1)
        premix = params
        mixed = {k: mm(op, t.reshape(g, n, -1)).reshape(t.shape) for k, t in premix.items()}
        p_grad, p_apply = premix, mixed
        m_new, v_new, step_new = m, v2, step
        row_loss = torch.zeros(g * n, device=dev)
        for s in range(setup.local_steps):
            w = idx[:, :, s].reshape(g * n, -1)
            if keep_batch is not None:
                w = w[:, :keep_batch]
            bx, by = setup.x[node[:, None], w], setup.y[node[:, None], w]
            leaves = {k: t.detach().requires_grad_(True) for k, t in p_grad.items()}
            with torch.enable_grad():
                loss = torch.mean(torch.square(lstm(leaves, bx, mm) - by), dim=1)
                grads = torch.autograd.grad(loss.sum(), [leaves[k] for k in LEAVES])
            grads = dict(zip(LEAVES, grads))
            if first_grad is None:  # as the optimizer got it: inactive rows' state stays 0
                first_grad = {k: grads[k] * flat_act.reshape(-1, *[1] * (grads[k].dim() - 1))
                              for k in LEAVES}
            step_new = step_new + 1
            bc1 = 1 - torch.pow(setup.b1, step_new)
            bc2 = 1 - torch.pow(setup.b2, step_new)
            upd = {}
            for k in LEAVES:
                shape = (-1,) + (1,) * (grads[k].dim() - 1)
                mk = setup.b1 * m_new[k] + (1 - setup.b1) * grads[k]
                vk = setup.b2 * v_new[k] + (1 - setup.b2) * torch.square(grads[k])
                update = (mk / bc1.reshape(shape)) / (torch.sqrt(vk / bc2.reshape(shape))
                                                      + setup.eps)
                upd[k] = (mk, vk, p_apply[k] - setup.lr * update)
            m_new = {k: upd[k][0] for k in LEAVES}
            v_new = {k: upd[k][1] for k in LEAVES}
            p_apply = {k: upd[k][2] for k in LEAVES}
            p_grad = p_apply
            row_loss = row_loss + loss.detach()
        row_loss = row_loss / setup.local_steps

        def keep(new, old):
            return {k: torch.where(flat_act.reshape(-1, *[1] * (new[k].dim() - 1)) > 0,
                                   new[k], old[k]) for k in LEAVES}
        params, m, v2 = keep(p_apply, premix), keep(m_new, m), keep(v_new, v2)
        step = torch.where(flat_act > 0, step_new, step)
        num = (row_loss.reshape(g, n) * act).sum(dim=1)
        losses.append((num / act.sum(dim=1).clamp_min(1.0)).cpu().numpy())
    pops = {k: t.reshape(g, n, *t.shape[1:]).mean(dim=1) for k, t in params.items()}
    return Readings(
        loss=np.stack(losses, axis=1),
        grad=leaf_norms(first_grad, g),
        change=change_norms(params, init, g),
        val=val_rmse(pops, setup, mm),
        pop=flat_pops(pops),
    )


def flat_pops(pops: dict) -> np.ndarray:
    """(G, D) populations on the host, the leaves in ``LEAVES`` order."""
    g = pops["wx"].shape[0]
    return torch.cat([pops[k].reshape(g, -1) for k in LEAVES], dim=1).cpu().numpy()
