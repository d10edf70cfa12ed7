"""Mamba-2 language model, the attention-free SSM family (a port of
``repro.arch.ssm_lm``).

Each layer is a pre-norm residual Mamba-2 block (``nn/ssm.py``).  The
tree keeps JAX's layout (``layers`` holds every leaf stacked over a
leading L) and the layers run as a Python loop.  As in ``arch/lm.py``:
``forward`` and ``loss_fn`` are differentiable (each layer under
``arch.common.remat`` with grad mode on), ``prefill`` and
``decode_step`` run under ``arch.sharding.serving_mode``
(``torch.inference_mode()``; ``torch.no_grad()`` on DTensor params),
``constrain_act`` pins the residual stream before and after each layer
and ``gather_fsdp`` gathers a layer's FSDP weight shards inside its body
(both the identity on plain tensors), and the params are in
``cfg.dtype`` unless fp32 masters are asked for.

Kept from the reference: ``prefill`` returns the last position's logits
and the zero states of ``init_state``, not the states the prompt left
(JAX's "kept simple here"), so decode after prefill starts as if no
prompt had been read.  ``tests/test_torch_ssm.py`` pins it in both
packages.  The head here is applied to the last position only (per
position, so the same logits as JAX's ``dense`` on it).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.arch.common import (cast_params, compute_dtype, cross_entropy, index_stacked,
                                     put_stacked, remat, unstack)
from repro_torch.arch.sharding import constrain_act, gather_fsdp, serving_mode
from repro_torch.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.nn.layers import dense, embed, normal, pad_vocab, rms_norm
from repro_torch.nn.ssm import init_mamba2_block, init_mamba2_state, mamba2_block, mamba2_decode

PyTree = Any


def _dims(cfg: ArchConfig) -> dict:
    nheads = cfg.ssm_heads or (cfg.ssm_expand * cfg.d_model // 64)
    return dict(expand=cfg.ssm_expand, nheads=nheads, dstate=cfg.ssm_state)


def init_params(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype | None = None) -> PyTree:
    """Random params from ``gen`` on its device, in ``dtype`` (default
    ``cfg.dtype``), with JAX's distributions (not its numbers), one
    layer at a time into the stacked tensors."""
    dtype = dtype or compute_dtype(cfg.dtype)
    vp, d = pad_vocab(cfg.vocab_size), cfg.d_model
    layers: dict = {}
    for i in range(cfg.num_layers):
        layer = {"ln_scale": torch.zeros((d,), dtype=dtype, device=gen.device),
                 "mamba": init_mamba2_block(gen, d, dtype=dtype, **_dims(cfg))}
        put_stacked(layers, layer, i, cfg.num_layers)
    return {
        "embed": normal(gen, (vp, d), 0.02, dtype),
        "layers": layers,
        "final_scale": torch.zeros((d,), dtype=dtype, device=gen.device),
        "lm_head": normal(gen, (d, vp), d ** -0.5, dtype),
    }


def _trunk(params, cfg: ArchConfig, tokens):
    """Embedding and every layer: the last hidden states (B, S, d)."""
    x = embed(tokens, params["embed"], compute_dtype(cfg.dtype))

    def body(x, lp):
        lp, x = gather_fsdp(lp), constrain_act(x)
        h = rms_norm(x, lp["ln_scale"], cfg.norm_eps)
        return constrain_act(x + mamba2_block(h, lp["mamba"], chunk=cfg.ssm_chunk, **_dims(cfg)))

    for lp in unstack(params["layers"]):
        x = remat(body, x, lp)
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


def init_state(cfg: ArchConfig, batch: int, device=None) -> PyTree:
    """Per-layer decode states stacked over L: {"conv": (L, B, K-1, C) in
    ``cfg.dtype``, "ssm": (L, B, H, P, N) fp32}, zeros.  O(1) in the
    context length."""
    one = init_mamba2_state(batch, cfg.d_model, dtype=compute_dtype(cfg.dtype),
                            device=resolve_device(device), **_dims(cfg))
    return {k: torch.stack([t] * cfg.num_layers) for k, t in one.items()}


@serving_mode
def prefill(params, cfg: ArchConfig, batch):
    """(last-position logits (B, 1, Vp), ``init_state``'s zero states)."""
    params = gather_fsdp(cast_params(params, compute_dtype(cfg.dtype)))
    x = _trunk(params, cfg, batch["tokens"])[:, -1:]
    x = rms_norm(x, params["final_scale"], cfg.norm_eps)
    tokens = batch["tokens"]
    return dense(x, params["lm_head"]), init_state(cfg, tokens.shape[0], tokens.device)


@serving_mode
def decode_step(params, cfg: ArchConfig, states, batch):
    """One decode step.  batch = {"token": (B, 1) int, "pos": unused};
    ``states`` as :func:`init_state` gives them.  Returns (logits (B, 1,
    Vp), new states); the given states are not changed."""
    dtype = compute_dtype(cfg.dtype)
    params = gather_fsdp(cast_params(params, dtype))
    x = embed(batch["token"], params["embed"], dtype)[:, 0, :]  # (B, d)
    new = []
    for i in range(cfg.num_layers):
        lp = gather_fsdp(index_stacked(params["layers"], i))
        h = rms_norm(x, lp["ln_scale"], cfg.norm_eps)
        out, st = mamba2_decode(h, lp["mamba"], index_stacked(states, i), **_dims(cfg))
        x = x + out
        new.append(st)
    x = rms_norm(x[:, None, :], params["final_scale"], cfg.norm_eps)
    return dense(x, params["lm_head"]), {k: torch.stack([st[k] for st in new]) for k in new[0]}
