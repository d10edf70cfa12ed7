"""Decoder-only LM assembly for the dense, MoE and VLM families (a port
of ``repro.arch.lm``).

One parameter tree, three entry points:
  * ``forward``      -- whole-sequence logits (teacher forcing),
  * ``prefill``      -- last-position logits plus per-layer KV caches
                        (the last ``cache_capacity`` positions),
  * ``decode_step``  -- one token against the caches.

The tree keeps JAX's layout: ``layers`` holds each leaf stacked over a
leading L, and ``arch.common.params_from_numpy`` carries a JAX tree across
as it is.
The layers run as a Python loop.  ``forward`` (and so ``loss_fn``) is
differentiable: with grad mode on, each layer runs under
``arch.common.remat`` (JAX scans them under ``jax.checkpoint``), and
``make_train_step`` differentiates it.  ``prefill`` and ``decode_step``
run under ``arch.sharding.serving_mode`` (``torch.inference_mode()``;
``torch.no_grad()`` on DTensor params).  The self-attention goes through
``nn.attention.gqa_attention``, whose banded branch is the hand-written
``swa_attention`` kernel without grad and the plain
``banded_flash_attention`` (the function JAX differentiates) with it.

Serving never updates params, so by default ``init_params`` and
``params_from_numpy`` give every leaf in ``cfg.dtype`` (bf16 for the
full configs), which computes the same function as JAX's fp32 masters
cast per call by ``cast_params`` (at Mistral-Large's full width the fp32
masters of 4 layers alone would take 22 GB of the card).  Training asks
for fp32 leaves (``dtype=torch.float32``), which ``forward`` casts at
entry, as JAX does.

A config with ``num_experts > 0`` runs ``nn.moe.moe_ffn`` in place of
the SwiGLU in every layer; ``forward`` returns the layers' mean
(load_balance, router_z) and ``loss_fn`` adds them as JAX does.

JAX's sharding hints sit where JAX has them (``arch.sharding``): the
residual stream is pinned by ``constrain_act`` before and after each
layer, q/k/v by ``constrain_attn``.  Where DTensor, unlike GSPMD, must
be told, the module redistributes explicitly (all the identity on plain
tensors): ``split_heads`` splits the q/k/v projections into heads (a
fused projection replicated on "model" where its shard would not fall
on head boundaries), ``merge_heads`` merges them for the output
projection, ``constrain_act`` also resolves the residual's pending sums
after the attention's add, and ``gather_fsdp`` gathers a layer's FSDP
weight shards inside its body (JAX's "weights all-gather per layer on
use"), the embedding's and head's at entry.

Known fault, kept from the reference: ``prefill`` returns caches of
``min(S, window)`` slots (S for full attention) in plain order, and the
first ``decode_step`` writes slot ``S % capacity``.  Decode after
prefill is right only for a sliding window with ``S % window == 0``;
ROADMAP Queue 3 has the fix, and ``tests/test_torch_arch.py`` pins it.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.arch.common import (cast_params, compute_dtype, cross_entropy, put_stacked, remat,
                                     unstack)
from repro_torch.arch.sharding import (constrain_act, constrain_attn, gather_fsdp, merge_heads,
                                      serving_mode, split_heads)
from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn.attention import KVCache, decode_attention, gqa_attention
from repro_torch.nn.layers import dense, embed, init_swiglu, normal, pad_vocab, rms_norm, rope, swiglu_ffn
from repro_torch.nn.moe import init_moe, moe_ffn

PyTree = Any

VISION_STUB_DIM = 1024  # stubbed vision-encoder embedding width
LOAD_BALANCE_WEIGHT = 0.01  # the MoE aux losses' weights in loss_fn
ROUTER_Z_WEIGHT = 1e-3


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_layer(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    h, k = cfg.num_heads, cfg.num_kv_heads

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=gen.device)

    p = {
        "ln1_scale": zeros(d),
        "ln2_scale": zeros(d),
        "wq": normal(gen, (d, h * hd), d ** -0.5, dtype),
        "wk": normal(gen, (d, k * hd), d ** -0.5, dtype),
        "wv": normal(gen, (d, k * hd), d ** -0.5, dtype),
        "wo": normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype),
    }
    if cfg.attn_bias:
        p.update(bq=zeros(h * hd), bk=zeros(k * hd), bv=zeros(k * hd))
    if cfg.num_experts:
        p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.num_experts, dtype)
    else:
        p.update(init_swiglu(gen, d, cfg.d_ff, dtype))
    return p


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype | None = None) -> PyTree:
    """Random params from ``gen`` on its device, in ``dtype`` (default
    ``cfg.dtype``; fp32 for a train state's masters), with JAX's
    distributions (normal at JAX's scales, zero norm gains).  Each leaf
    is drawn in fp32 and cast, one layer at a time into the stacked
    tensors, so the fp32 transient is one leaf."""
    dtype = dtype or compute_dtype(cfg.dtype)
    vp, d = pad_vocab(cfg.vocab_size), cfg.d_model
    layers: dict = {}
    for i in range(cfg.num_layers):
        put_stacked(layers, init_layer(gen, cfg, dtype), i, cfg.num_layers)
    p = {
        "embed": normal(gen, (vp, d), 0.02, dtype),
        "layers": layers,
        "final_scale": torch.zeros((d,), dtype=dtype, device=gen.device),
        "lm_head": normal(gen, (d, vp), d ** -0.5, dtype),
    }
    if cfg.family == "vlm":
        p["vision_proj"] = {"w_in": normal(gen, (VISION_STUB_DIM, d), VISION_STUB_DIM ** -0.5, dtype)}
    return p


# ---------------------------------------------------------------------------
# layer body (shared by forward / prefill / decode)
# ---------------------------------------------------------------------------


def qkv(x, lp, cfg: ArchConfig, positions):
    """q, k (rotated) and v of an attention layer's weights ``lp`` (its
    optional biases too; the hybrid's attention blocks have none)."""
    h, k, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = split_heads(dense(x, lp["wq"], lp.get("bq")), h, hd)
    kk = split_heads(dense(x, lp["wk"], lp.get("bk")), k, hd)
    v = split_heads(dense(x, lp["wv"], lp.get("bv")), k, hd)
    q = constrain_attn(rope(q, positions, cfg.rope_theta), "bshd")
    kk = constrain_attn(rope(kk, positions, cfg.rope_theta), "bshd", kv=True)
    return q, kk, constrain_attn(v, "bshd", kv=True)


def ffn(h, lp, cfg: ArchConfig):
    """The layer's MLP on the normed h: (out, aux), aux the MoE's losses
    or {} for the SwiGLU."""
    if cfg.num_experts:
        return moe_ffn(h, lp["moe"], top_k=cfg.experts_per_token,
                       capacity_factor=cfg.expert_capacity_factor)
    return swiglu_ffn(h, lp), {}


def layer_forward(x, lp, cfg: ArchConfig, positions):
    """Whole-sequence layer; returns (x, (k, v), aux).  With
    ``cfg.parallel_block`` attention and MLP both read norm(x) and add to
    one residual (PaLM style), as in JAX."""
    h = rms_norm(x, lp["ln1_scale"], cfg.norm_eps)
    q, k, v = qkv(h, lp, cfg, positions)
    attn = gqa_attention(q, k, v, causal=True, window=cfg.sliding_window)
    attn_out = dense(merge_heads(attn), lp["wo"])
    if cfg.parallel_block:
        ff, aux = ffn(h, lp, cfg)
        return x + attn_out + ff, (k, v), aux
    x = constrain_act(x + attn_out)  # the residual's pending sums over "model" resolved
    ff, aux = ffn(rms_norm(x, lp["ln2_scale"], cfg.norm_eps), lp, cfg)
    return x + ff, (k, v), aux


def layer_decode(x, lp, cache: KVCache, cfg: ArchConfig, pos):
    """One-token layer.  x (B, 1, d); pos the absolute position (0-d)."""
    h = rms_norm(x, lp["ln1_scale"], cfg.norm_eps)
    q, k, v = qkv(h, lp, cfg, pos.reshape(1))
    cache = cache.append(k, v)
    attn = decode_attention(q, cache, window=cfg.sliding_window)
    x = constrain_act(x + dense(attn.reshape(x.shape[0], 1, -1), lp["wo"]))
    return x + ffn(rms_norm(x, lp["ln2_scale"], cfg.norm_eps), lp, cfg)[0], cache


# ---------------------------------------------------------------------------
# model-level entry points
# ---------------------------------------------------------------------------


def _layers(params):
    return unstack(params["layers"])


def _embed_inputs(params, cfg: ArchConfig, batch, dtype):
    """Token (and VLM patch) embedding -> (B, S, d)."""
    x = embed(batch["tokens"], params["embed"], dtype)
    if cfg.family == "vlm":
        patches = batch["patches"].to(dtype)  # (B, Tv, VISION_STUB_DIM)
        x = torch.cat([dense(patches, params["vision_proj"]["w_in"]), x], dim=1)
    return x


def forward(params, cfg: ArchConfig, batch):
    """Teacher-forcing logits (B, S_total, Vp) and the (2,) fp32 mean
    over layers of (load_balance, router_z) (zeros without MoE).
    Differentiable; each layer rematerialised under grad mode."""
    dtype = compute_dtype(cfg.dtype)
    params = gather_fsdp(cast_params(params, dtype))
    x = _embed_inputs(params, cfg, batch, dtype)
    positions = torch.arange(x.shape[1], device=x.device)

    def body(x, lp):
        x, _, aux = layer_forward(constrain_act(x), gather_fsdp(lp), cfg, positions)
        return constrain_act(x), (torch.stack([aux["load_balance"], aux["router_z"]]) if aux
                   else torch.zeros((2,), device=x.device))

    aux_rows = []
    x = constrain_act(x)
    for lp in _layers(params):
        x, aux = remat(body, x, lp)
        aux_rows.append(aux)
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    return dense(x, params["lm_head"]), torch.stack(aux_rows).mean(dim=0)


def loss_fn(params, cfg: ArchConfig, batch):
    """Mean next-token CE against ``batch["labels"]``, plus the MoE's
    weighted aux losses; differentiable."""
    logits, aux = forward(params, cfg, batch)
    ce = cross_entropy(logits, batch["labels"])
    if cfg.num_experts:
        ce = ce + LOAD_BALANCE_WEIGHT * aux[0] + ROUTER_Z_WEIGHT * aux[1]
    return ce


def cache_capacity(cfg: ArchConfig, seq_len: int) -> int:
    return min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len


def init_cache(cfg: ArchConfig, batch: int, seq_len: int, device=None) -> KVCache:
    """Stacked (L-leading) empty caches for decode."""
    cap, dev = cache_capacity(cfg, seq_len), resolve_device(device)
    shape = (cfg.num_layers, batch, cap, cfg.num_kv_heads, cfg.head_dim)
    dtype = compute_dtype(cfg.dtype)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev),
                   pos=torch.zeros((cfg.num_layers,), dtype=torch.int32, device=dev))


@serving_mode
def prefill(params, cfg: ArchConfig, batch):
    """Prefill: (last-position logits (B, 1, Vp), stacked KV caches with
    leaves (L, B, cap, K, hd) and pos (L,) = S)."""
    dtype = compute_dtype(cfg.dtype)
    params = gather_fsdp(cast_params(params, dtype))
    x = _embed_inputs(params, cfg, batch, dtype)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    cap = cache_capacity(cfg, s)
    ks, vs = [], []
    for lp in _layers(params):
        x, (k, v), _ = layer_forward(constrain_act(x), gather_fsdp(lp), cfg, positions)
        x = constrain_act(x)
        ks.append(k[:, s - cap:])  # the last `cap` positions, in plain order
        vs.append(v[:, s - cap:])
    x = rms_norm(x[:, -1:], params["final_scale"], cfg.norm_eps)
    caches = KVCache(k=torch.stack(ks), v=torch.stack(vs),
                     pos=torch.full((len(ks),), s, dtype=torch.int32, device=x.device))
    return dense(x, params["lm_head"]), caches


@serving_mode
def decode_step(params, cfg: ArchConfig, caches: KVCache, batch):
    """One decode step.  batch = {"token": (B, 1) int, "pos": the absolute
    position, an int or a 0-d tensor}; ``caches`` leaves have a leading L.
    Returns (logits (B, 1, Vp), new caches); the given caches are not
    changed."""
    dtype = compute_dtype(cfg.dtype)
    params = gather_fsdp(cast_params(params, dtype))
    x = embed(batch["token"], params["embed"], dtype)
    pos = torch.as_tensor(batch["pos"], device=x.device)
    new = []
    for i, lp in enumerate(_layers(params)):
        x, cache = layer_decode(x, gather_fsdp(lp), KVCache(caches.k[i], caches.v[i], caches.pos[i]),
                                cfg, pos)
        new.append(cache)
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    caches = KVCache(k=torch.stack([c.k for c in new]), v=torch.stack([c.v for c in new]),
                     pos=torch.stack([c.pos for c in new]))
    return dense(x, params["lm_head"]), caches
