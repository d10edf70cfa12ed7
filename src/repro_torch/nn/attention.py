"""GQA attention: plain, blocked-flash and banded self-attention, and
decode against a KV cache (a port of ``repro.nn.attention``).

  * ``gqa_attention`` -- self-attention over a whole sequence (prefill),
    with JAX's dispatch and thresholds: up to ``flash_threshold`` keys a
    plain masked softmax; above it, a causal sliding window whose band
    is shorter than the sequence goes to the hand-written CUDA kernel
    ``swa_attention`` through ``kernels.ops`` (on a CPU tensor, its plain
    twin), and everything else to a blocked flash attention with an
    online softmax over KV blocks.  Under autograd (grad mode on and q,
    k or v requiring grad) the banded shape takes the plain
    ``banded_flash_attention`` instead, the function JAX's train step
    differentiates: the kernel has no backward, as the Pallas kernel has
    no ``custom_vjp``.  The choice is made before any launch.
    :data:`BRANCHES` counts the branch each call takes.
  * ``decode_attention`` -- one query token against a ``KVCache``.
  * ``KVCache`` -- append-only for full attention, a ring of ``window``
    slots for sliding windows.

``plain_attention``, ``flash_attention`` and ``banded_flash_attention``
are plain PyTorch, as JAX leaves them to XLA; the port's gqa_attention
calls ``banded_flash_attention`` only under autograd (the kernel takes
its place without grad), and it is the reference that tests and
``chip_smoke.py`` hold the kernel against.  JAX's ``constrain_attn``
sharding hints are the identity on one device and are left out, as is
``nn/unroll.py``'s scan knob: the block loops here are Python loops.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30

BRANCHES = {"plain": 0, "flash": 0, "banded": 0, "banded_grad": 0}


def _repeat_kv(k: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K * q_per_kv, hd), each KV head repeated
    for the q_per_kv query heads that share it."""
    return k if q_per_kv == 1 else k.repeat_interleave(q_per_kv, dim=2)


def plain_attention(q, k, v, *, causal: bool, window: int = 0, q_offset: int = 0):
    """Reference masked attention.  q (B, Sq, H, hd), k/v (B, Skv, K, hd).
    Scores are computed in the input dtype and softmaxed in fp32; the
    probabilities go back to the input dtype for the product with v."""
    sq, h, hd = q.shape[1], q.shape[2], q.shape[3]
    k = _repeat_kv(k, h // k.shape[2])
    v = _repeat_kv(v, h // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(k.shape[1], device=q.device)
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = torch.where(mask, scores, torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_attention(q, k, v, *, causal: bool, window: int = 0, block: int = 1024):
    """Blocked flash attention (online softmax) over KV blocks of
    ``block`` keys, in fp32; never materialises (Sq, Skv), only
    (B, H, Sq, block).  With a window, blocks wholly outside it still run
    and contribute zero (the banded branch skips them)."""
    b, sq, h, hd = q.shape
    skv = k.shape[1]
    assert skv % block == 0 or skv < block, (skv, block)
    block = min(block, skv)
    qpk = h // k.shape[2]
    qf = (q.float() * (hd ** -0.5)).transpose(1, 2)  # (B, H, Sq, hd)
    acc = torch.zeros((b, h, sq, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    qpos = torch.arange(sq, device=q.device)[:, None]
    for start in range(0, skv, block):
        kb = _repeat_kv(k[:, start:start + block], qpk).transpose(1, 2).float()
        vb = _repeat_kv(v[:, start:start + block], qpk).transpose(1, 2).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        kpos = start + torch.arange(block, device=q.device)[None, :]
        mask = torch.ones((sq, block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        scale = torch.exp(m - m_new)
        l = l * scale + p.sum(dim=-1)
        acc = acc * scale[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def banded_flash_attention(q, k, v, *, window: int, block: int = 1024):
    """Sliding-window causal attention over the diagonal band only, in
    plain PyTorch: each block of ``block`` queries attends to the
    ceil(window / block) + 1 KV blocks ending at its own, through
    ``plain_attention``.  O(S * window)."""
    b, sq, h, hd = q.shape
    assert sq % block == 0, (sq, block)
    kv_blocks = -(-window // block) + 1
    outs = []
    for qi in range(sq // block):
        lo = max(qi - kv_blocks + 1, 0)
        span = slice(lo * block, (lo + kv_blocks) * block)
        outs.append(plain_attention(q[:, qi * block:(qi + 1) * block], k[:, span], v[:, span],
                                    causal=True, window=window, q_offset=(qi - lo) * block))
    return torch.cat(outs, dim=1)


def gqa_attention(q, k, v, *, causal: bool = True, window: int = 0,
                  flash_threshold: int = 2048, block: int = 1024):
    """Self-attention over a whole sequence, dispatched as
    ``repro.nn.attention.gqa_attention`` dispatches (module docstring).
    q (B, S, H, hd), k/v (B, S, K, hd) -> (B, S, H, hd)."""
    skv, sq = k.shape[1], q.shape[1]
    if skv <= flash_threshold:
        BRANCHES["plain"] += 1
        return plain_attention(q, k, v, causal=causal, window=window)
    band_span = (-(-window // block) + 1) * block if window > 0 else 0
    if window > 0 and sq == skv and sq % block == 0 and block <= window and band_span < sq:
        # JAX's banded path is causal whatever ``causal`` says; so is the
        # kernel, which takes every hd (RecurrentGemma's 256 among them)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            BRANCHES["banded_grad"] += 1
            return banded_flash_attention(q, k, v, window=window, block=block)
        BRANCHES["banded"] += 1
        return ops.swa_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=window)
    BRANCHES["flash"] += 1
    return flash_attention(q, k, v, causal=causal, window=window, block=block)


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------


@dataclass
class KVCache:
    """KV cache for decode.  Full attention: append-only of ``capacity``
    slots.  Sliding window: a ring of ``capacity`` slots.  A single
    layer's leaves are k, v (B, C, K, hd) and pos a 0-d int32 tensor
    (tokens written so far); the model's stacked caches add a leading L
    to all three."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor

    @staticmethod
    def init(batch: int, capacity: int, kv_heads: int, head_dim: int, dtype,
             device=None) -> "KVCache":
        shape = (batch, capacity, kv_heads, head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device),
                       pos=torch.zeros((), dtype=torch.int32, device=device))

    def append(self, k_new, v_new) -> "KVCache":
        """One token's K/V (B, 1, K, hd) at slot ``pos % capacity`` (ring
        semantics when full); returns a new cache, as JAX does."""
        slot = (self.pos % self.k.shape[1]).reshape(1).long()
        return KVCache(k=self.k.index_copy(1, slot, k_new.to(self.k.dtype)),
                       v=self.v.index_copy(1, slot, v_new.to(self.v.dtype)),
                       pos=self.pos + 1)


def decode_attention(q, cache: KVCache, *, window: int = 0):
    """One-step attention: q (B, 1, H, hd) against the cache after the
    append.  Slots not yet written are masked; in a ring cache every
    written slot is inside the window by construction, so ``window``
    changes nothing (as in JAX)."""
    h, hd = q.shape[2], q.shape[3]
    k = _repeat_kv(cache.k, h // cache.k.shape[2])
    v = _repeat_kv(cache.v, h // cache.v.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
    valid = torch.arange(cache.k.shape[1], device=q.device) < cache.pos
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
