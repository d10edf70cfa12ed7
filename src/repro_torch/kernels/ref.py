"""Plain PyTorch twins of the port's kernels (the counterpart of
``repro.kernels.ref``).

The CPU path runs these, the CPU tests hold them against the JAX
package, and ``chip_smoke.py`` holds each CUDA kernel against its twin
on the card.  Nothing on the CUDA path calls them.
"""
from __future__ import annotations

import torch


def lstm_cell_plain(x_t, h, c, wx, wh, b):
    """One LSTM step, gates ordered (i, f, g, o) as in
    ``repro.kernels.ref.lstm_cell_ref``.  Shapes: x_t (B, I), h/c (B, H),
    wx (I, 4H), wh (H, 4H), b (4H,)."""
    z = x_t @ wx + h @ wh + b
    i, f, g, o = z.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def lstm_forward_plain(x, wx, wh, b, w_out, b_out):
    """L LSTM steps from zero state, then the linear head, with one
    weight set per group: the function the ``lstm_forward`` kernel
    computes.

    x (G, R, L, I); wx (G, I, 4H); wh (G, H, 4H); b (G, 4H);
    w_out (G, H, 1); b_out (G, 1)  ->  y (G, R).

    Each group runs as its own sequence of same-shaped matmuls, so a
    group's result does not depend on how many groups share the call.
    """
    _, r, steps, _ = x.shape
    hidden = wh.shape[1]
    ys = []
    for g in range(x.shape[0]):
        h = x.new_zeros((r, hidden))
        c = x.new_zeros((r, hidden))
        for t in range(steps):
            h, c = lstm_cell_plain(x[g, :, t, :], h, c, wx[g], wh[g], b[g])
        ys.append((h @ w_out[g] + b_out[g])[:, 0])
    return torch.stack(ys)


def lstm_gates_fwd_plain(gates, x, wx, b, c_prev, c, h):
    """Step t of the trainer's LSTM forward in place, the function the
    ``lstm_gates_fwd`` kernel computes: ``gates`` (N, B, 4H) holds
    ``h_{t-1} @ wh`` (not read when ``c_prev`` is None and ``x`` is
    given: step 0) and becomes the activated (i, f, g, o) of
    ``(gates + x @ wx) + b``, the order of
    ``repro_torch.models.lstm.lstm_cell``'s sum; ``c`` and ``h`` receive
    ``c_t = f c_{t-1} + i g`` and ``h_t = o tanh(c_t)``.  x (N, B, 1) and
    wx (N, 1, 4H), or both None when ``gates`` already holds
    ``x_t @ wx``; b (N, 4H), c_prev/c/h (N, B, H)."""
    z = gates if c_prev is not None or x is None else torch.zeros_like(gates)
    if x is not None:
        z = z + torch.bmm(x, wx)
    i, f, g, o = (z + b[:, None, :]).chunk(4, dim=-1)
    cp = c_prev if c_prev is not None else torch.zeros_like(c)
    i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
    c_new = f * cp + i * g
    h.copy_(o * torch.tanh(c_new))
    c.copy_(c_new)
    gates.copy_(torch.cat([i, f, g, o], dim=-1))


def lstm_gates_bwd_plain(gates, c_prev, c, dh, dc, x, db, dwx, accumulate):
    """Step t of the trainer's LSTM backward in place, the function the
    ``lstm_gates_bwd`` kernel computes: from the activated gates
    (N, B, 4H), ``c_prev`` = c_{t-1} (None at step 0), ``c`` = c_t,
    ``dh`` = dL/dh_t and ``dc`` = dL/dc_t through step t+1, ``gates``
    becomes dL/d(pre-activation) and ``dc`` dL/dc_{t-1}; ``db`` (N, 4H)
    and ``dwx`` (N, 1, 4H) receive ``sum_b dG`` and ``x^T dG``, added to
    what they hold when ``accumulate`` (x and dwx None: db alone).  Each
    product is rounded as autograd's backward of ``lstm_cell`` rounds
    it."""
    i, f, g, o = gates.chunk(4, dim=-1)
    cp = c_prev if c_prev is not None else torch.zeros_like(c)
    tc = torch.tanh(c)
    d_o = (dh * tc) * (1 - o) * o
    dct = dc + (dh * o) * (1 - tc * tc)
    dg = torch.cat([(dct * g) * (1 - i) * i, (dct * cp) * (1 - f) * f,
                    (dct * i) * (1 - g * g), d_o], dim=-1)
    dc.copy_(dct * f)
    gates.copy_(dg)
    sums = [(db, dg.sum(dim=1))]
    if x is not None:
        sums.append((dwx, torch.bmm(x.transpose(1, 2), dg)))
    for out, step in sums:
        if accumulate:
            out += step
        else:
            out.copy_(step)


def _select(active, mixed, w):
    """Active rows take the mix, inactive rows are bitwise copies of w."""
    return torch.where(active[:, None] > 0, mixed, w)


def _table_sum(idx, wgt, v):
    """``sum_b wgt[:, b] v[idx[:, b]]`` over the table's slots."""
    return torch.einsum("nb,nbd->nd", wgt, v[idx.long()])


def gossip_mix_plain(mix, w, active):
    """``out[n] = sum_m mix[n, m] w[m]`` where active, else ``w[n]``:
    the function the ``gossip_mix`` kernel computes.  mix (N, N),
    w (N, D), active (N,), float32.  Unlike
    ``repro.kernels.ref.gossip_mix_ref``, which blends
    ``act*mixed + (1-act)*w``, inactive rows are selected, so a NaN in an
    active row cannot reach them."""
    return _select(active, mix @ w, w)


def gossip_mix_sparse_plain(idx, wgt, w, active):
    """``out[n] = sum_b wgt[n, b] w[idx[n, b]]`` where active, else
    ``w[n]``: the ``gossip_mix_sparse`` kernel's function.  idx/wgt
    (N, S) neighbor table (slot 0 self), w (N, D)."""
    return _select(active, _table_sum(idx, wgt, w), w)


def gossip_mix_dp_plain(mix, w, z, active):
    """Dense local-DP gossip, ``sum_m mix[n, m] (w + z)[m] - mix[n, n]
    z[n]`` where active, else ``w[n]``: every node shares a noised view
    and re-adds its own clean self-contribution."""
    return _select(active, mix @ (w + z) - torch.diagonal(mix)[:, None] * z, w)


def gossip_mix_sparse_dp_plain(idx, wgt, w, z, active):
    """Sparse local-DP gossip, ``sum_b wgt[n, b] (w + z)[idx[n, b]] -
    wgt[n, 0] z[n]`` where active, else ``w[n]`` (slot 0 is self, so
    ``wgt[:, 0]`` is the densified diagonal)."""
    return _select(active, _table_sum(idx, wgt, w + z) - wgt[:, :1] * z, w)


def swa_attention_plain(q, k, v, *, window: int, scale: float | None = None):
    """Causal sliding-window attention, the function the
    ``swa_attention`` kernel computes: query i attends to the keys j with
    i - window < j <= i.  q (B, S, H, hd); k, v (B, S, K, hd) with
    H % K == 0, repeated to H heads here and then computed as
    ``repro.kernels.ref.swa_attention_ref``: fp32 scores scaled by
    ``scale`` (hd**-0.5 unless given), masked with -1e30, softmax and the
    product with v in fp32, the result in q's dtype.  It materialises
    (B, H, S, S) scores."""
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    rep = h // k.shape[2]
    kf = k.float().repeat_interleave(rep, dim=2)
    vf = v.float().repeat_interleave(rep, dim=2)
    scale = hd ** -0.5 if scale is None else scale
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * scale
    pos = torch.arange(s, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    scores = torch.where(mask, scores, torch.full((), -1e30, device=q.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)


def swa_bf16_bound(q, k, v, *, window: int, attention=swa_attention_plain):
    """The elementwise limit within which a bf16 ``swa_attention`` must
    agree with the fp32 attention on the same inputs:
    ``2^-8 (|o32| + (P|v|) / l) + 3e-5``.  ``o32`` is the fp32
    attention; ``(P|v|) / l`` is the same attention applied to |v|.  The
    kernel rounds each probability to bf16 before the product with v (up
    to 2^-9 of p_j, so 2^-9 sum_j p_j |v_j| / l on the output) and the
    output once (2^-9 |o|); the bound allows twice both, on top of the
    fp32 kernel's 3e-5.  ``attention(q, k, v, window=...)`` is any fp32
    implementation of the function (the twin by default; at long S the
    banded path)."""
    q32, k32, v32 = q.float(), k.float(), v.float()
    o32 = attention(q32, k32, v32, window=window)
    pv = attention(q32, k32, v32.abs(), window=window)
    return (o32.abs() + pv) * 2.0 ** -8 + 3e-5
