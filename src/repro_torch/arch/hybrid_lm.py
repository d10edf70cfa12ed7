"""RecurrentGemma-style hybrid LM (a port of ``repro.arch.hybrid_lm``):
RG-LRU recurrent blocks and local (sliding-window) attention blocks in a
repeating pattern (default 2:1), each followed by a gated MLP, per
Griffin (arXiv:2402.19427).

Layers are grouped into super-blocks of one pattern period, as in JAX:
38 configured layers / 3 -> 13 super-blocks (39 layers).  ``blocks``
holds one dict per kind of the pattern (rglru, rglru, attn), each leaf
stacked over the super-blocks, and ``arch.common.params_from_numpy``
carries a JAX tree across as it is.  The super-blocks run as a Python
loop; ``forward`` and ``loss_fn`` are differentiable (each super-block
under ``arch.common.remat`` with grad mode on), ``prefill`` and
``decode_step`` run under ``arch.sharding.serving_mode``
(``torch.inference_mode()``; ``torch.no_grad()`` on DTensor params),
``constrain_act`` pins the residual stream before and after each
super-block and after each residual add inside it, and ``gather_fsdp``
gathers a super-block's FSDP weight shards inside its body (all the
identity on plain tensors).  Each
local-attention block goes through ``nn.attention.gqa_attention``,
whose banded branch is the hand-written ``swa_attention`` kernel (hd
256, one KV head at RecurrentGemma's width) without grad.

As ``arch/lm.py`` does, serving holds only the compute-dtype copy of
the params (bf16 at full width, about 21 GB), the same function as
JAX's fp32 masters cast per call; training asks ``init_params`` or
``params_from_numpy`` for fp32 masters.  ``prefill`` returns the last
position's logits and no state, as JAX's ``build_arch`` does; it
applies the final norm and head to that position only (both are per
position; the full (1, 8192, 256,000) bf16 logits would take 4.2 GB).

Decode starts from ``init_state``, whose ring KV caches hold
min(seq_len, window) slots, as in JAX: decoding past seq_len tokens with
seq_len < window keeps only the last seq_len keys in view, fewer than
the window allows.  Both packages do so, and
``tests/test_torch_hybrid.py`` pins it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.arch.common import (cast_params, compute_dtype, cross_entropy, index_stacked,
                                     put_stacked, remat, unstack)
from repro_torch.arch.lm import qkv
from repro_torch.arch.sharding import constrain_act, gather_fsdp, merge_heads, serving_mode
from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn import rglru
from repro_torch.nn.attention import KVCache, decode_attention, gqa_attention
from repro_torch.nn.layers import dense, embed, init_swiglu, normal, pad_vocab, rms_norm, swiglu_ffn

PyTree = Any


def _pattern(cfg: ArchConfig) -> tuple:
    return cfg.block_pattern or ("rglru", "rglru", "attn")


def num_super_blocks(cfg: ArchConfig) -> int:
    return max(1, round(cfg.num_layers / len(_pattern(cfg))))


def _width(cfg: ArchConfig) -> int:
    return cfg.lru_width or cfg.d_model


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sub(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    if kind == "rglru":
        mix = {"rec": rglru.init_recurrent_block(gen, d, _width(cfg), dtype)}
    else:
        h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        mix = {
            "wq": normal(gen, (d, h * hd), d ** -0.5, dtype),
            "wk": normal(gen, (d, kh * hd), d ** -0.5, dtype),
            "wv": normal(gen, (d, kh * hd), d ** -0.5, dtype),
            "wo": normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype),
        }
    return {
        "ln1_scale": torch.zeros((d,), dtype=dtype, device=gen.device),
        "ln2_scale": torch.zeros((d,), dtype=dtype, device=gen.device),
        "mix": mix,
        "mlp": init_swiglu(gen, d, cfg.d_ff, dtype),
    }


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype | None = None) -> PyTree:
    """Random params from ``gen`` on its device, in ``dtype`` (default
    ``cfg.dtype``), with JAX's distributions (not its numbers), one
    sub-block at a time into the stacked tensors."""
    dtype = dtype or compute_dtype(cfg.dtype)
    vp, d = pad_vocab(cfg.vocab_size), cfg.d_model
    pat, nsb = _pattern(cfg), num_super_blocks(cfg)
    blocks: list[dict] = [{} for _ in pat]
    for sb in range(nsb):
        for i, kind in enumerate(pat):
            put_stacked(blocks[i], _init_sub(gen, cfg, kind, dtype), sb, nsb)
    return {
        "embed": normal(gen, (vp, d), 0.02, dtype),
        "blocks": blocks,
        "final_scale": torch.zeros((d,), dtype=dtype, device=gen.device),
        "lm_head": normal(gen, (d, vp), d ** -0.5, dtype),
    }


# ---------------------------------------------------------------------------
# forward / prefill
# ---------------------------------------------------------------------------


def _super_forward(x, sub: list, cfg: ArchConfig, positions):
    for bp, kind in zip(sub, _pattern(cfg)):
        h = rms_norm(x, bp["ln1_scale"], cfg.norm_eps)
        if kind == "rglru":
            mix = rglru.recurrent_block(h, bp["mix"]["rec"])
        else:
            q, k, v = qkv(h, bp["mix"], cfg, positions)
            attn = gqa_attention(q, k, v, causal=True, window=cfg.local_attn_window)
            mix = dense(merge_heads(attn), bp["mix"]["wo"])
        x = constrain_act(x + mix)
        x = constrain_act(x + swiglu_ffn(rms_norm(x, bp["ln2_scale"], cfg.norm_eps), bp["mlp"]))
    return x


def _trunk(params, cfg: ArchConfig, tokens):
    """Embedding and every super-block: the last hidden states (B, S, d)."""
    dtype = compute_dtype(cfg.dtype)
    x = embed(tokens, params["embed"], dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, sub):
        return constrain_act(_super_forward(constrain_act(x), gather_fsdp(sub), cfg, positions))

    for sub in zip(*(unstack(kind) for kind in params["blocks"])):
        x = remat(body, x, list(sub))
    return x


def forward(params, cfg: ArchConfig, batch):
    """Teacher-forcing logits (B, S, Vp) and the (2,) aux losses (zeros);
    differentiable."""
    params = gather_fsdp(cast_params(params, compute_dtype(cfg.dtype)))
    x = rms_norm(_trunk(params, cfg, batch["tokens"]), params["final_scale"], cfg.norm_eps)
    return dense(x, params["lm_head"]), torch.zeros((2,), device=x.device)


def loss_fn(params, cfg: ArchConfig, batch):
    """Mean next-token CE against ``batch["labels"]``; differentiable."""
    logits, _ = forward(params, cfg, batch)
    return cross_entropy(logits, batch["labels"])


@serving_mode
def prefill(params, cfg: ArchConfig, batch):
    """(last-position logits (B, 1, Vp), None): JAX's
    ``forward(...)[0][:, -1:]``, with the final norm and head on that
    position only."""
    params = gather_fsdp(cast_params(params, compute_dtype(cfg.dtype)))
    x = _trunk(params, cfg, batch["tokens"])[:, -1:]
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    return dense(x, params["lm_head"]), None


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_state(cfg: ArchConfig, batch: int, seq_len: int, device=None) -> PyTree:
    """Per-super-block state, stacked over the super-blocks: ``rec{i}``
    {"conv": (nsb, B, K-1, W), "h": (nsb, B, W) fp32} for a recurrent
    block i of the pattern, ``kv{i}`` a ring ``KVCache`` of
    min(seq_len, window) slots (leaves (nsb, B, cap, K, hd), pos (nsb,))
    for an attention block."""
    dev, dtype = resolve_device(device), compute_dtype(cfg.dtype)
    nsb, cap = num_super_blocks(cfg), min(seq_len, cfg.local_attn_window)
    state = {}
    for i, kind in enumerate(_pattern(cfg)):
        if kind == "rglru":
            one = rglru.init_recurrent_state(batch, _width(cfg), dtype, dev)
            state[f"rec{i}"] = {k: torch.stack([t] * nsb) for k, t in one.items()}
        else:
            shape = (nsb, batch, cap, cfg.num_kv_heads, cfg.head_dim)
            state[f"kv{i}"] = KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                                      v=torch.zeros(shape, dtype=dtype, device=dev),
                                      pos=torch.zeros((nsb,), dtype=torch.int32, device=dev))
    return state


def _super_decode(x, sub: list, cfg: ArchConfig, st: dict, pos):
    new = {}
    for i, (bp, kind) in enumerate(zip(sub, _pattern(cfg))):
        h = rms_norm(x, bp["ln1_scale"], cfg.norm_eps)
        if kind == "rglru":
            out, new[f"rec{i}"] = rglru.recurrent_block_decode(h[:, 0], bp["mix"]["rec"],
                                                               st[f"rec{i}"])
            mix = out[:, None, :]
        else:
            q, k, v = qkv(h, bp["mix"], cfg, pos.reshape(1))
            cache = st[f"kv{i}"].append(k, v)
            attn = decode_attention(q, cache, window=cfg.local_attn_window)
            new[f"kv{i}"] = cache
            mix = dense(attn.reshape(x.shape[0], 1, -1), bp["mix"]["wo"])
        x = constrain_act(x + mix)
        x = constrain_act(x + swiglu_ffn(rms_norm(x, bp["ln2_scale"], cfg.norm_eps), bp["mlp"]))
    return x, new


@serving_mode
def decode_step(params, cfg: ArchConfig, states, batch):
    """One decode step.  batch = {"token": (B, 1) int, "pos": the absolute
    position, an int or a 0-d tensor}; ``states`` as :func:`init_state`
    gives them.  Returns (logits (B, 1, Vp), new states); the given
    states are not changed."""
    dtype = compute_dtype(cfg.dtype)
    params = gather_fsdp(cast_params(params, dtype))
    x = embed(batch["token"], params["embed"], dtype)
    pos = torch.as_tensor(batch["pos"], device=x.device)
    steps = []
    for sb in range(num_super_blocks(cfg)):
        st = {key: (KVCache(s.k[sb], s.v[sb], s.pos[sb]) if isinstance(s, KVCache)
                    else index_stacked(s, sb)) for key, s in states.items()}
        sub = gather_fsdp([index_stacked(kind, sb) for kind in params["blocks"]])
        x, new = _super_decode(x, sub, cfg, st, pos)
        steps.append(new)
    stacked = {}
    for key, first in steps[0].items():
        if isinstance(first, KVCache):
            stacked[key] = KVCache(*(torch.stack([getattr(s[key], f) for s in steps])
                                     for f in ("k", "v", "pos")))
        else:
            stacked[key] = {f: torch.stack([s[key][f] for s in steps]) for f in first}
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    return dense(x, params["lm_head"]), stacked
