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
    no ``custom_vjp``.  On DTensors (the multi-GPU layout of
    ``arch/sharding.py``) sharded on batch and heads, each branch runs
    on the rank's own shards (``on_shards``): the banded shape launches
    the kernel on a CUDA mesh's shards and takes the twin on a CPU
    mesh's, as a plain tensor does.  Only a fake tensor (the dry run's
    trace, which has no data and no card) takes ``banded_flash_attention``
    there, the function JAX's dry run lowers (:func:`_banded`).  The
    choice is made before any launch.  :data:`BRANCHES` counts the
    branch each call takes.
  * ``decode_attention`` -- one query token against a ``KVCache``.
  * ``KVCache`` -- append-only for full attention, a ring of ``window``
    slots for sliding windows.

``plain_attention``, ``flash_attention`` and ``banded_flash_attention``
are plain PyTorch, as JAX leaves them to XLA; the port's gqa_attention
calls ``banded_flash_attention`` only under autograd (the kernel takes
its place without grad), and it is the reference that tests and
``chip_smoke.py`` hold the kernel against.  JAX's ``constrain_attn``
sharding hints sit where JAX has them in the flash attention (the
identity on plain tensors and under the dry run's policy, which pins
no attention axis); ``nn/unroll.py``'s scan knob is left out: the
block loops here are Python loops.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.arch.sharding import constrain_attn, keep_batch, match_heads
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
    _, sq, h, hd = q.shape
    skv = k.shape[1]
    assert skv % block == 0 or skv < block, (skv, block)
    block = min(block, skv)
    qpk = h // k.shape[2]
    qf = constrain_attn((q.float() * (hd ** -0.5)).transpose(1, 2), "bhsd")  # (B, H, Sq, hd)
    # the carries made like qf, so that on DTensors they take its shards
    contiguous = dict(dtype=torch.float32, memory_format=torch.contiguous_format)
    acc = constrain_attn(torch.zeros_like(qf, **contiguous), "bhsd")
    m = constrain_attn(torch.full_like(qf[..., 0], NEG_INF, **contiguous), "bhs")
    l = constrain_attn(torch.zeros_like(qf[..., 0], **contiguous), "bhs")
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
        l = constrain_attn(l * scale + p.sum(dim=-1), "bhs")
        acc = constrain_attn(acc * scale[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb),
                             "bhsd")
        m = constrain_attn(m_new, "bhs")
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
        return on_shards(plain_attention, q, k, v, causal=causal, window=window)
    band_span = (-(-window // block) + 1) * block if window > 0 else 0
    if window > 0 and sq == skv and sq % block == 0 and block <= window and band_span < sq:
        # JAX's banded path is causal whatever ``causal`` says; so is the
        # kernel, which takes every hd (RecurrentGemma's 256 among them)
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            BRANCHES["banded_grad"] += 1
            return on_shards(banded_flash_attention, q, k, v, window=window, block=block)
        BRANCHES["banded"] += 1
        return on_shards(_banded, q, k, v, window=window, block=block)
    BRANCHES["flash"] += 1
    return on_shards(flash_attention, q, k, v, causal=causal, window=window, block=block)


def _banded(q, k, v, *, window: int, block: int):
    """The banded shape on one rank's tensors: ``swa_attention`` through
    ``kernels.ops`` (the kernel on a CUDA tensor, its plain twin on a CPU
    one).  A fake tensor (the dry run's trace) takes
    ``banded_flash_attention``: the twin's (B, H, S, S) fp32 scores would
    set a peak that the card, whose kernel holds only its output, never
    reaches (at Mistral-Large's ``prefill_32k`` on the (16, 16) mesh,
    52 GB a rank for one copy of them)."""
    if is_fake(q):
        return banded_flash_attention(q, k, v, window=window, block=block)
    return ops.swa_attention(q.contiguous(), k.contiguous(), v.contiguous(), window=window)


def on_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)``; on DTensors, on each rank's own shards.
    Attention is independent per batch row and per head, and no ``fn``
    here reads across either: with k and v repeated to q's heads and
    placed as q (``arch.sharding.match_heads``, a local slice), a rank
    whose q is sharded on batch and heads only runs ``fn`` on its rows
    and heads, as GSPMD partitions it, and the result is placed as q.
    DTensor would instead flatten the sharded batch and head dims into
    its batched matmuls, which older releases refuse and newer ones
    plan at length.  Any other layout (a sharded sequence) keeps the
    DTensor ops."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kw)
    h = q.shape[2]
    k = match_heads(_repeat_kv(k, h // k.shape[2]), q)
    v = match_heads(_repeat_kv(v, h // v.shape[2]), q)
    rows_heads = all(p == Replicate() or (isinstance(p, Shard) and p.dim in (0, 2))
                     for p in q.placements)
    if not (rows_heads and tuple(k.placements) == tuple(q.placements) == tuple(v.placements)):
        return fn(q, k, v, **kw)
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, q.device_mesh, q.placements, run_check=False)


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
        if isinstance(self.k, DTensor):
            # DTensor has no rule for index_copy along a sharded dim (the
            # dry run shards the slots on "model"): the same write as a
            # select against the slot, local on every shard of the slots
            # (the new token's K/V whole beside its batch shard)
            hit = (torch.arange(self.k.shape[1], device=slot.device) == slot).reshape(1, -1, 1, 1)
            return KVCache(k=torch.where(hit, keep_batch(k_new).to(self.k.dtype), self.k),
                           v=torch.where(hit, keep_batch(v_new).to(self.v.dtype), self.v),
                           pos=self.pos + 1)
        return KVCache(k=self.k.index_copy(1, slot, k_new.to(self.k.dtype)),
                       v=self.v.index_copy(1, slot, v_new.to(self.v.dtype)),
                       pos=self.pos + 1)


def decode_attention(q, cache: KVCache, *, window: int = 0):
    """One-step attention: q (B, 1, H, hd) against the cache after the
    append.  Slots not yet written are masked; in a ring cache every
    written slot is inside the window by construction, so ``window``
    changes nothing (as in JAX)."""
    h, hd = q.shape[2], q.shape[3]
    # on DTensors the cache's slots are split over "model": the heads whole
    q = keep_batch(q)
    k = _repeat_kv(cache.k, h // cache.k.shape[2])
    v = _repeat_kv(cache.v, h // cache.v.shape[2])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * (hd ** -0.5)
    valid = torch.arange(cache.k.shape[1], device=q.device) < cache.pos
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
