"""Mamba-2 SSD (state-space duality) layer in its chunked matmul form (a
port of ``repro.nn.ssm``).

The chunked algorithm (Dao & Gu, 2024) turns the linear recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ,   y_t = C_t h_t + D x_t

into blocks: within-chunk attention-like matmuls masked by cumulative
decays, and an inter-chunk state recurrence over S/chunk steps (JAX's
``lax.scan``, a loop here, one fused multiply-add a chunk, with no
``out=`` write, so that autograd runs it for the train step).  JAX writes
the block products as 4-operand einsums and leaves their order to
``opt_einsum``; here each is explicit steps that keep the B/C groups
unrepeated (G of them, shared by H/G heads each), so that nothing of
(B, S/chunk, chunk, H, N) is materialised.  Everything inside is fp32,
as in JAX: x, dt, B, C, ``a_log`` and ``d_skip`` are cast up and y cast
back to x's dtype.

Shapes: x (B, S, H, P) heads x headdim, dt (B, S, H), A (H,) (negative),
Bm/Cm (B, S, G, N), D (H,).  Decode keeps h (B, H, P, N): O(1) a token.

On DTensors (the multi-GPU layout of ``arch/sharding.py``) the SSD's
inputs are redistributed explicitly at its entry (``keep_batch``: x and
dt sharded on heads, B and C replicated, beside the batch shard) and
the SSD runs on each rank's local shards (:func:`_ssd_on_shards`), so
that the chunk loop never slices a sharded dim.  Plain tensors take
:func:`_ssd_forward` directly.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from torch.distributed.tensor import DTensor, Shard

from repro_torch.arch.sharding import keep_batch, local_like
from repro_torch.nn.layers import normal, rms_norm

CONV_K = 4


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Causal segment sums: out[..., i, j] = sum_{k=j+1..i} a[..., k],
    -inf above the diagonal (as a difference of cumulative sums, as in
    JAX).  a (..., Q) -> (..., Q, Q)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_forward(x, dt, a_log, bm, cm, d_skip, *, chunk: int = 64):
    """Chunked SSD.  Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) fp32)."""
    with record_function("ssm.ssd"):  # the profiler's span of the SSD's passes
        if isinstance(x, DTensor):
            return _ssd_on_shards(x, dt, a_log, bm, cm, d_skip, chunk)
        return _ssd_forward(x, dt, a_log, bm, cm, d_skip, chunk)


def _ssd_on_shards(x, dt, a_log, bm, cm, d_skip, chunk):
    """The SSD of DTensors on each rank's own shards: it is independent
    per batch row and per head, and every head reads the one group's B
    and C (G=1, every config of the zoo).  x and dt are sharded on batch
    and heads alike, B and C on batch only, ``a_log`` and ``d_skip`` on
    the same heads (``arch.sharding.keep_batch``, ``local_like``), and
    the chunked SSD runs on the local tensors; y comes back placed as x,
    the final state (B, H, P, N) on the same batch and heads."""
    if bm.shape[2] != 1:
        raise NotImplementedError("the SSD on shards takes one B/C group")
    x, dt, bm, cm = keep_batch(x, 2), keep_batch(dt, 2), keep_batch(bm), keep_batch(cm)
    y, state = _ssd_forward(
        x.to_local(), local_like(dt, x, {0: 0, 2: 2}), local_like(a_log, x, {2: 0}),
        local_like(bm, x, {0: 0}), local_like(cm, x, {0: 0}), local_like(d_skip, x, {2: 0}),
        chunk)
    mesh = x.device_mesh
    state_pl = [Shard({0: 0, 2: 1}[p.dim]) if isinstance(p, Shard) else p for p in x.placements]
    return (DTensor.from_local(y, mesh, x.placements, run_check=False),
            DTensor.from_local(state, mesh, state_pl, run_check=False))


def _ssd_forward(x, dt, a_log, bm, cm, d_skip, chunk):
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc, q, rep = s // chunk, chunk, h // g

    dt = F.softplus(dt.float())                                  # (B, S, H) > 0
    a = dt * a_log.float()[None, None, :]                        # log decay < 0
    xdt = x.float() * dt[..., None]                              # x pre-scaled by dt
    # per chunk, heads split into (group, head in group)
    xc = xdt.reshape(b, nc, q, g, rep, p).permute(0, 1, 3, 4, 2, 5)  # (B, NC, G, R, Q, P)
    ac = a.reshape(b, nc, q, h).permute(0, 3, 1, 2)              # (B, H, NC, Q)
    bc = bm.float().reshape(b, nc, q, g, n).transpose(2, 3)      # (B, NC, G, Q, N)
    cc = cm.float().reshape(b, nc, q, g, n).transpose(2, 3)

    # 1. within-chunk (attention-like) term: (C B^T ∘ L) x
    decay = torch.exp(_segsum(ac)).permute(0, 2, 1, 3, 4)        # (B, NC, H, Q, Q)
    scores = (cc @ bc.transpose(-1, -2))[:, :, :, None] * decay.reshape(b, nc, g, rep, q, q)
    y_diag = scores @ xc                                         # (B, NC, G, R, Q, P)

    # 2. each chunk's input state: sum_k decay_k x_k B_k^T
    a_cum = torch.cumsum(ac, dim=-1)                             # (B, H, NC, Q)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum).permute(0, 2, 1, 3)  # (B, NC, H, Q)
    xd = xc * decay_states.reshape(b, nc, g, rep, q, 1)
    states = xd.transpose(-1, -2).reshape(b, nc, g, rep * p, q) @ bc  # (B, NC, G, R·P, N)
    states = states.reshape(b, nc, h, p, n)

    # 3. inter-chunk recurrence: prev[c] is the state before chunk c (a
    # list stacked once, so that autograd can run it)
    chunk_decay = torch.exp(a_cum[..., -1]).permute(2, 0, 1)     # (NC, B, H)
    prev = [torch.zeros_like(states[:, 0], memory_format=torch.contiguous_format)]
    for c in range(nc):
        prev.append(torch.addcmul(states[:, c], chunk_decay[c][..., None, None], prev[c]))
    prev = torch.stack(prev)

    # 4. state -> output term: C h_prev, decayed to each position
    hp = prev[:nc].permute(1, 0, 2, 3, 4).reshape(b, nc, g, rep * p, n)
    y_off = (cc @ hp.transpose(-1, -2)).reshape(b, nc, g, q, rep, p)  # (B, NC, G, Q, R, P)
    state_decay = torch.exp(a_cum).permute(0, 2, 1, 3).reshape(b, nc, g, rep, q)
    y_off = y_off * state_decay.transpose(-1, -2)[..., None]

    y = y_diag.permute(0, 1, 4, 2, 3, 5) + y_off.transpose(2, 3)  # (B, NC, Q, G, R, P)
    y = y.reshape(b, s, h, p) + x.float() * d_skip.float()[None, None, :, None]
    return y.to(x.dtype), prev[nc]


def ssd_decode_step(x_t, dt_t, a_log, b_t, c_t, d_skip, h_state):
    """One decode step.  x_t (B, H, P), dt_t (B, H), b_t/c_t (B, G, N),
    h_state (B, H, P, N) fp32 -> (y_t (B, H, P), new state).  On
    DTensors every input is whole beside its batch shard (a token's
    worth; the batched products flatten the heads)."""
    x_t, dt_t, b_t, c_t, h_state = (keep_batch(t) for t in (x_t, dt_t, b_t, c_t, h_state))
    h = x_t.shape[1]
    rep = h // b_t.shape[1]
    dt = F.softplus(dt_t.float())
    decay = torch.exp(dt * a_log.float()[None, :])                    # (B, H)
    bh = b_t.float().repeat_interleave(rep, dim=1)                    # (B, H, N)
    ch = c_t.float().repeat_interleave(rep, dim=1)
    xdt = x_t.float() * dt[..., None]
    h_new = decay[..., None, None] * h_state + xdt[..., None] * bh[:, :, None, :]
    y = (h_new @ ch[..., None])[..., 0]
    y = y + x_t.float() * d_skip.float()[None, :, None]
    return y.to(x_t.dtype), h_new


# ---------------------------------------------------------------------------
# The Mamba-2 block: projections, short causal conv, SSD, gate
# ---------------------------------------------------------------------------


def init_mamba2_block(gen: torch.Generator, d: int, *, expand: int, nheads: int, dstate: int,
                      ngroups: int = 1, dtype=torch.float32) -> dict:
    """Random block params from ``gen`` with JAX's distributions, in
    ``dtype``."""
    d_inner = expand * d
    conv_dim = d_inner + 2 * ngroups * dstate
    dev = gen.device
    a_log = -torch.exp(torch.rand((nheads,), generator=gen, device=dev) * 2.0 - 1.0)
    return {
        "in_proj": normal(gen, (d, 2 * d_inner + 2 * ngroups * dstate + nheads), d ** -0.5, dtype),
        "conv_w": normal(gen, (CONV_K, conv_dim), 0.2, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "a_log": a_log.to(dtype),
        "dt_bias": normal(gen, (nheads,), 0.1, dtype),
        "d_skip": torch.ones((nheads,), dtype=dtype, device=dev),
        "norm_scale": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "out_proj": normal(gen, (d_inner, d), d_inner ** -0.5, dtype),
    }


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of kernel ``w.shape[0]``, then SiLU, in u's
    dtype (``repro.nn.ssm._causal_conv``): u (B, S, C), w (K, C), b (C,).
    Position t sums ``u[t - K + 1 + i] * w[i]`` over i in order, with
    zeros before the start.  On DTensors, on each rank's own batch rows
    and channels (the sequence whole), as the SSD runs."""
    if isinstance(u, DTensor):
        u = keep_batch(u, -1)
        out = _causal_conv(u.to_local(), local_like(w, u, {2: 1}), local_like(b, u, {2: 0}))
        return DTensor.from_local(out, u.device_mesh, u.placements, run_check=False)
    return _causal_conv(u, w, b)


def _causal_conv(u, w, b):
    k, s = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * w[i].to(u.dtype) for i in range(k))
    return F.silu(out + b.to(u.dtype))


def _split(zxbcdt, d_inner: int, ngroups: int, dstate: int):
    gn = ngroups * dstate
    return torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, zxbcdt.shape[-1] - 2 * d_inner - 2 * gn],
                       dim=-1)


def mamba2_block(x, p, *, expand: int, nheads: int, dstate: int, ngroups: int = 1,
                 chunk: int = 64):
    """Block forward (train / prefill).  x (B, S, d) -> (B, S, d)."""
    b, s, d = x.shape
    d_inner = expand * d
    z, xbc, dt = _split(x @ p["in_proj"].to(x.dtype), d_inner, ngroups, dstate)
    xbc = causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs, bm, cm = torch.split(xbc, [d_inner, ngroups * dstate, ngroups * dstate], dim=-1)
    dt = dt + p["dt_bias"].to(dt.dtype)[None, None, :]
    y, _ = ssd_forward(xs.reshape(b, s, nheads, d_inner // nheads), dt, p["a_log"],
                       bm.reshape(b, s, ngroups, dstate), cm.reshape(b, s, ngroups, dstate),
                       p["d_skip"], chunk=chunk)
    y = rms_norm(y.reshape(b, s, d_inner) * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"].to(x.dtype)


def mamba2_decode(x_t, p, state, *, expand: int, nheads: int, dstate: int, ngroups: int = 1):
    """One-token decode.  x_t (B, d); state = {"conv": (B, K-1, C),
    "ssm": (B, H, P, N) fp32} -> (out (B, d), new state)."""
    b, d = x_t.shape
    d_inner = expand * d
    z, xbc, dt = _split(x_t @ p["in_proj"].to(x_t.dtype), d_inner, ngroups, dstate)
    conv_in = torch.cat([state["conv"], xbc[:, None, :]], dim=1)  # (B, K, C)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", conv_in, p["conv_w"].to(x_t.dtype))
                      + p["conv_b"].to(x_t.dtype))
    xs, bm, cm = torch.split(conv_out, [d_inner, ngroups * dstate, ngroups * dstate], dim=-1)
    dt = dt + p["dt_bias"].to(dt.dtype)[None, :]
    y, new_ssm = ssd_decode_step(xs.reshape(b, nheads, d_inner // nheads), dt, p["a_log"],
                                 bm.reshape(b, ngroups, dstate), cm.reshape(b, ngroups, dstate),
                                 p["d_skip"], state["ssm"])
    y = rms_norm(y.reshape(b, d_inner) * F.silu(z), p["norm_scale"])
    return y @ p["out_proj"].to(x_t.dtype), {"conv": conv_in[:, 1:], "ssm": new_ssm}


def init_mamba2_state(batch: int, d: int, *, expand: int, nheads: int, dstate: int,
                      ngroups: int = 1, dtype=torch.float32, device=None) -> dict:
    d_inner = expand * d
    conv_dim = d_inner + 2 * ngroups * dstate
    return {
        "conv": torch.zeros((batch, CONV_K - 1, conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nheads, d_inner // nheads, dstate), dtype=torch.float32,
                           device=device),
    }
