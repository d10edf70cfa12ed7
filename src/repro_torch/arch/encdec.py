"""Whisper-style encoder-decoder, the audio family (a port of
``repro.arch.encdec``).

The mel-spectrogram and conv front end is a stub, as in JAX: the batch
carries precomputed frame embeddings ``frames`` (B, S_enc, d), and this
module runs the transformer encoder and decoder that consume them:
pre-LN layers with biases, sinusoidal positions in the encoder, learned
ones in the decoder, MHA (num_kv_heads == num_heads), and the head tied
to the token embedding.  Attention goes through
``nn.attention.gqa_attention`` (no window, so its plain or flash branch:
Whisper's 1,500 frames and 448 tokens take the plain one).

The tree keeps JAX's layout (``enc_layers`` and ``dec_layers`` stacked
over a leading L).  As in ``arch/lm.py``: ``forward`` and ``loss_fn``
are differentiable (each encoder and decoder layer under
``arch.common.remat`` with grad mode on), ``prefill``, ``init_state``
and ``decode_step`` run under ``arch.sharding.serving_mode``
(``torch.inference_mode()``; ``torch.no_grad()`` on DTensor params),
``constrain_act`` pins the residual stream before and after each layer
and after each residual add, ``split_heads`` and ``merge_heads`` split
and merge the attention's heads, ``gather_fsdp`` gathers a layer's FSDP
weight shards inside its body, and the decode's cross attention runs on
each rank's heads (``keep_batch``, ``match_heads``, ``on_shards``; all
the identity on plain tensors),
and the params are in ``cfg.dtype`` unless fp32 masters are asked for.

Kept from the reference: ``init_state`` without ``frames`` (the one
``build_arch``'s ``init_decode_state`` calls) cross-attends a zero
encoder output, so its cross K is 0 and V the bias.  The serving path
passes the frames.  ``tests/test_torch_encdec.py`` pins both.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.arch.common import (cast_params, compute_dtype, cross_entropy, index_stacked,
                                     put_stacked, remat, sinusoidal_positions, unstack)
from repro_torch.arch.sharding import (constrain_act, gather_fsdp, keep_batch, match_heads,
                                      merge_heads, serving_mode, split_heads)
from repro_torch.config import ArchConfig
from repro_torch.nn.attention import (KVCache, decode_attention, gqa_attention, on_shards,
                                     plain_attention)
from repro_torch.nn.layers import (dense, embed, gelu_ffn, init_gelu_ffn, layer_norm, normal,
                                   pad_vocab)

PyTree = Any

# Whisper's decoder context is 448; the assigned shapes go to 32k, so the
# learned position table is sized to them (JAX's choice)
MAX_DECODER_POS = 32_768


def _init_attn(gen: torch.Generator, d: int, h: int, hd: int, dtype) -> dict:
    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=gen.device)

    return {
        "wq": normal(gen, (d, h * hd), d ** -0.5, dtype), "bq": zeros(h * hd),
        "wk": normal(gen, (d, h * hd), d ** -0.5, dtype),
        "wv": normal(gen, (d, h * hd), d ** -0.5, dtype), "bv": zeros(h * hd),
        "wo": normal(gen, (h * hd, d), (h * hd) ** -0.5, dtype), "bo": zeros(d),
    }


def _ln_init(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype | None = None) -> PyTree:
    """Random params from ``gen`` on its device, in ``dtype`` (default
    ``cfg.dtype``), with JAX's distributions (not its numbers), one
    layer at a time into the stacked tensors."""
    dtype, dev = dtype or compute_dtype(cfg.dtype), gen.device
    vp, d, h, hd = pad_vocab(cfg.vocab_size), cfg.d_model, cfg.num_heads, cfg.head_dim
    enc: dict = {}
    for i in range(cfg.encoder_layers):
        layer = {"ln1": _ln_init(d, dtype, dev), "ln2": _ln_init(d, dtype, dev),
                 "attn": _init_attn(gen, d, h, hd, dtype),
                 "mlp": init_gelu_ffn(gen, d, cfg.d_ff, dtype)}
        put_stacked(enc, layer, i, cfg.encoder_layers)
    dec: dict = {}
    for i in range(cfg.num_layers):
        layer = {"ln1": _ln_init(d, dtype, dev), "ln2": _ln_init(d, dtype, dev),
                 "ln3": _ln_init(d, dtype, dev),
                 "self_attn": _init_attn(gen, d, h, hd, dtype),
                 "cross_attn": _init_attn(gen, d, h, hd, dtype),
                 "mlp": init_gelu_ffn(gen, d, cfg.d_ff, dtype)}
        put_stacked(dec, layer, i, cfg.num_layers)
    return {
        "enc_layers": enc,
        "enc_final_ln": _ln_init(d, dtype, dev),
        "dec_layers": dec,
        "dec_final_ln": _ln_init(d, dtype, dev),
        "embed": normal(gen, (vp, d), 0.02, dtype),
        "pos_embed": normal(gen, (MAX_DECODER_POS, d), 0.01, dtype),
    }


def _ln(x, p):
    return layer_norm(x, p["scale"], p["bias"])


def _mha(x, ap, cfg: ArchConfig, *, kv=None, causal: bool):
    h, hd = cfg.num_heads, cfg.head_dim
    src = x if kv is None else kv
    q = split_heads(dense(x, ap["wq"], ap["bq"]), h, hd)
    k = split_heads(dense(src, ap["wk"]), h, hd)
    v = split_heads(dense(src, ap["wv"], ap["bv"]), h, hd)
    out = gqa_attention(q, k, v, causal=causal)
    return dense(merge_heads(out), ap["wo"], ap["bo"])


def encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames: the stubbed front end's output (B, S_enc, d) -> (B, S_enc,
    d) in ``cfg.dtype``."""
    dtype = compute_dtype(cfg.dtype)
    x = frames.to(dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device).to(dtype)[None]

    def body(x, lp):
        lp, x = gather_fsdp(lp), constrain_act(x)
        x = constrain_act(x + _mha(_ln(x, lp["ln1"]), lp["attn"], cfg, causal=False))
        return constrain_act(x + gelu_ffn(_ln(x, lp["ln2"]), lp["mlp"]))

    for lp in unstack(params["enc_layers"]):
        x = remat(body, x, lp)
    return _ln(x, params["enc_final_ln"])


def _decoder(params, cfg: ArchConfig, tokens, enc_out):
    """The decoder's hidden states (B, S, d) after its final norm."""
    dtype = compute_dtype(cfg.dtype)
    x = embed(tokens, params["embed"], dtype)
    x = x + params["pos_embed"][:x.shape[1]].to(dtype)[None]

    def body(x, lp, enc_out):
        lp, x = gather_fsdp(lp), constrain_act(x)
        x = constrain_act(x + _mha(_ln(x, lp["ln1"]), lp["self_attn"], cfg, causal=True))
        x = constrain_act(x + _mha(_ln(x, lp["ln2"]), lp["cross_attn"], cfg, kv=enc_out,
                                   causal=False))
        return constrain_act(x + gelu_ffn(_ln(x, lp["ln3"]), lp["mlp"]))

    for lp in unstack(params["dec_layers"]):
        x = remat(body, x, lp, enc_out)
    return _ln(x, params["dec_final_ln"])


def _head(x, params):
    """The tied output head (whisper ties the token embedding)."""
    return x @ params["embed"].T.to(x.dtype)


def decode_train(params, cfg: ArchConfig, tokens, enc_out):
    """Teacher-forcing decoder logits (B, S, Vp)."""
    return _head(_decoder(params, cfg, tokens, enc_out), params)


def forward(params, cfg: ArchConfig, batch):
    """Teacher-forcing logits (B, S, Vp) and the (2,) aux losses (zeros);
    differentiable."""
    params = gather_fsdp(cast_params(params, compute_dtype(cfg.dtype)))
    logits = decode_train(params, cfg, batch["tokens"], encode(params, cfg, batch["frames"]))
    return logits, torch.zeros((2,), device=logits.device)


def loss_fn(params, cfg: ArchConfig, batch):
    """Mean next-token CE against ``batch["labels"]``; differentiable."""
    logits, _ = forward(params, cfg, batch)
    return cross_entropy(logits, batch["labels"])


@serving_mode
def prefill(params, cfg: ArchConfig, batch):
    """(last-position logits (B, 1, Vp), None): JAX's
    ``forward(...)[0][:, -1:]``, with the head on that position only."""
    params = gather_fsdp(cast_params(params, compute_dtype(cfg.dtype)))
    x = _decoder(params, cfg, batch["tokens"], encode(params, cfg, batch["frames"]))
    return _head(x[:, -1:], params), None


# -- serving -----------------------------------------------------------------


@serving_mode
def init_state(params, cfg: ArchConfig, batch: int, seq_len: int, frames=None) -> PyTree:
    """Decode state: {"self": L-stacked ``KVCache`` of seq_len slots,
    "cross": {"k", "v"} (L, B, S_enc, H, hd)}, the cross K/V computed once
    from ``encode(frames)``, or from a zero encoder output without frames
    (as JAX does)."""
    dtype, dev = compute_dtype(cfg.dtype), params["embed"].device
    params = gather_fsdp(cast_params(params, dtype))
    h, hd, n = cfg.num_heads, cfg.head_dim, cfg.num_layers
    shape = (n, batch, seq_len, h, hd)
    self_caches = KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                          v=torch.zeros(shape, dtype=dtype, device=dev),
                          pos=torch.zeros((n,), dtype=torch.int32, device=dev))
    if frames is None:
        enc_out = torch.zeros((batch, cfg.encoder_seq, cfg.d_model), dtype=dtype, device=dev)
    else:
        enc_out = encode(params, cfg, frames)
    ks, vs = [], []
    for i in range(n):
        ca = gather_fsdp(index_stacked(params["dec_layers"], i)["cross_attn"])
        ks.append(dense(enc_out, ca["wk"]).reshape(batch, -1, h, hd))
        vs.append(dense(enc_out, ca["wv"], ca["bv"]).reshape(batch, -1, h, hd))
    return {"self": self_caches, "cross": {"k": torch.stack(ks), "v": torch.stack(vs)}}


@serving_mode
def decode_step(params, cfg: ArchConfig, state, batch):
    """One decode step.  batch = {"token": (B, 1) int, "pos": the absolute
    position, an int or a 0-d tensor}; ``state`` as :func:`init_state`
    gives it.  Returns (logits (B, 1, Vp), new state); the given state is
    not changed."""
    dtype = compute_dtype(cfg.dtype)
    params = gather_fsdp(cast_params(params, dtype))
    x = embed(batch["token"], params["embed"], dtype)
    pos = torch.as_tensor(batch["pos"], device=x.device)
    x = x + params["pos_embed"][(pos % MAX_DECODER_POS).reshape(1).long()].to(dtype)[None]
    b, h, hd = x.shape[0], cfg.num_heads, cfg.head_dim
    caches = state["self"]
    new = []
    for i in range(cfg.num_layers):
        lp = gather_fsdp(index_stacked(params["dec_layers"], i))
        sa, ca = lp["self_attn"], lp["cross_attn"]
        hst = _ln(x, lp["ln1"])
        q = dense(hst, sa["wq"], sa["bq"]).reshape(b, 1, h, hd)
        k = dense(hst, sa["wk"]).reshape(b, 1, h, hd)
        v = dense(hst, sa["wv"], sa["bv"]).reshape(b, 1, h, hd)
        cache = KVCache(caches.k[i], caches.v[i], caches.pos[i]).append(k, v)
        new.append(cache)
        x = constrain_act(x + dense(decode_attention(q, cache).reshape(b, 1, -1), sa["wo"],
                                    sa["bo"]))
        # on DTensors: the cross K/V on heads (the state may split their hd
        # or frames), the query placed as they are, each rank its own heads
        ck, cv = (keep_batch(t[i], 2) for t in (state["cross"]["k"], state["cross"]["v"]))
        qc = match_heads(dense(_ln(x, lp["ln2"]), ca["wq"], ca["bq"]).reshape(b, 1, h, hd), ck)
        cattn = on_shards(plain_attention, qc, ck, cv, causal=False)
        x = constrain_act(x + dense(cattn.reshape(b, 1, -1), ca["wo"], ca["bo"]))
        x = constrain_act(x + gelu_ffn(_ln(x, lp["ln3"]), lp["mlp"]))
    x = _ln(x, params["dec_final_ln"])
    caches = KVCache(*(torch.stack([getattr(c, f) for c in new]) for f in ("k", "v", "pos")))
    return _head(x, params), {"self": caches, "cross": state["cross"]}
