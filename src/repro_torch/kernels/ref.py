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
