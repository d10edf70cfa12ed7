"""Uniform architecture API and the assigned input shapes (a port of
``repro.arch.api``).

``build_arch(cfg)`` dispatches on ``cfg.family`` and returns an
:class:`Arch` with JAX's surface:

    init_params(gen, dtype=None) -> params   (a torch.Generator; its device;
                                             cfg.dtype, or fp32 masters)
    loss_fn(params, batch) -> scalar         (differentiable)
    prefill_fn(params, batch) -> (logits, caches)
    decode_fn(params, caches, batch) -> (logits, caches)
    init_decode_state(params, batch_size, seq_len) -> caches
    input_specs(shape_name) -> the batch as "meta" tensors (no allocation)
    decode_state_specs(shape_name) -> the decode state as "meta" tensors

Every family is ported: dense, MoE and VLM (``arch/lm.py``), the Mamba-2
SSM (``arch/ssm_lm.py``), the RG-LRU hybrid (``arch/hybrid_lm.py``) and
the Whisper encoder-decoder (``arch/encdec.py``).  The train step
(``TrainState``, ``init_train_state``, ``make_train_step``) is
re-exported from ``arch/common.py``, as JAX re-exports it.

Input shapes (assigned):
    train_4k     seq 4096    global batch 256   train step
    prefill_32k  seq 32768   global batch 32    prefill
    decode_32k   seq 32768   global batch 128   decode step (1 token)
    long_500k    seq 524288  global batch 1     decode step (sliding
                                                 window or recurrent only)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import ArchConfig

PyTree = Any

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass
class Arch:
    cfg: ArchConfig
    init_params: Callable
    loss_fn: Callable
    prefill_fn: Callable
    decode_fn: Callable
    init_decode_state: Callable
    supports_long: bool

    def supports(self, shape: str) -> bool:
        return self.supports_long if shape == "long_500k" else True

    def input_specs(self, shape_name: str, *, override_batch: int | None = None,
                    override_seq: int | None = None) -> PyTree:
        """The batch of ``shape_name`` as tensors on the meta device."""
        from repro_torch.arch.common import compute_dtype
        from repro_torch.arch.lm import VISION_STUB_DIM

        cfg, sh = self.cfg, SHAPES[shape_name]
        b = override_batch or sh.global_batch
        s = override_seq or sh.seq_len

        def spec(*shape, dtype=torch.int32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if sh.kind == "decode":
            return {"token": spec(b, 1), "pos": spec()}
        act = compute_dtype(cfg.dtype)
        out = {"tokens": spec(b, s)}
        if cfg.family == "vlm":
            tv = cfg.vision_tokens
            out = {"patches": spec(b, tv, VISION_STUB_DIM, dtype=act), "tokens": spec(b, s - tv)}
        if cfg.family == "encdec":
            out = {"frames": spec(b, cfg.encoder_seq, cfg.d_model, dtype=act), "tokens": spec(b, s)}
        if sh.kind == "train":
            out["labels"] = spec(b, s)
        return out

    def decode_state_specs(self, shape_name: str, *, override_batch: int | None = None,
                           override_seq: int | None = None) -> PyTree:
        """``init_decode_state``'s state for ``shape_name`` (its batch and
        sequence) as tensors on the meta device, the same structure:
        JAX's ``eval_shape`` of it.  The params (enc-dec's state reads
        them) and the state are built as fake tensors, so nothing is
        allocated."""
        from repro_torch.nn.attention import KVCache

        sh = SHAPES[shape_name]
        b = override_batch or sh.global_batch
        s = override_seq or sh.seq_len
        with FakeTensorMode():
            params = self.init_params(torch.Generator())
            state = self.init_decode_state(params, b, s)

        def meta(tree):
            if isinstance(tree, KVCache):
                return KVCache(*(meta(t) for t in (tree.k, tree.v, tree.pos)))
            if isinstance(tree, dict):
                return {k: meta(v) for k, v in tree.items()}
            return torch.empty(tuple(tree.shape), dtype=tree.dtype, device="meta")

        return meta(state)


def build_arch(cfg: ArchConfig) -> Arch:
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.arch import lm

        return Arch(
            cfg=cfg,
            init_params=lambda gen, dtype=None: lm.init_params(gen, cfg, dtype),
            loss_fn=lambda p, b: lm.loss_fn(p, cfg, b),
            prefill_fn=lambda p, b: lm.prefill(p, cfg, b),
            decode_fn=lambda p, st, b: lm.decode_step(p, cfg, st, b),
            init_decode_state=lambda p, bsz, s: lm.init_cache(
                cfg, bsz, s, p["embed"].device),
            supports_long=cfg.sliding_window > 0,
        )
    if cfg.family == "ssm":
        from repro_torch.arch import ssm_lm

        return Arch(
            cfg=cfg,
            init_params=lambda gen, dtype=None: ssm_lm.init_params(gen, cfg, dtype),
            loss_fn=lambda p, b: ssm_lm.loss_fn(p, cfg, b),
            prefill_fn=lambda p, b: ssm_lm.prefill(p, cfg, b),
            decode_fn=lambda p, st, b: ssm_lm.decode_step(p, cfg, st, b),
            init_decode_state=lambda p, bsz, s: ssm_lm.init_state(cfg, bsz, p["embed"].device),
            supports_long=True,
        )
    if cfg.family == "hybrid":
        from repro_torch.arch import hybrid_lm

        return Arch(
            cfg=cfg,
            init_params=lambda gen, dtype=None: hybrid_lm.init_params(gen, cfg, dtype),
            loss_fn=lambda p, b: hybrid_lm.loss_fn(p, cfg, b),
            prefill_fn=lambda p, b: hybrid_lm.prefill(p, cfg, b),
            decode_fn=lambda p, st, b: hybrid_lm.decode_step(p, cfg, st, b),
            init_decode_state=lambda p, bsz, s: hybrid_lm.init_state(
                cfg, bsz, s, p["embed"].device),
            supports_long=True,
        )
    if cfg.family == "encdec":
        from repro_torch.arch import encdec

        return Arch(
            cfg=cfg,
            init_params=lambda gen, dtype=None: encdec.init_params(gen, cfg, dtype),
            loss_fn=lambda p, b: encdec.loss_fn(p, cfg, b),
            prefill_fn=lambda p, b: encdec.prefill(p, cfg, b),
            decode_fn=lambda p, st, b: encdec.decode_step(p, cfg, st, b),
            init_decode_state=lambda p, bsz, s: encdec.init_state(p, cfg, bsz, s),
            supports_long=False,
        )
    raise KeyError(f"unknown family {cfg.family!r}")


# re-exported for launchers, as the JAX package does
from repro_torch.arch.common import TrainState, init_train_state, make_train_step  # noqa: E402,F401
