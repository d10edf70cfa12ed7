"""Decode demo for the assigned architectures (a port of
``repro.launch.arch_demo``): the LM zoo's KV-cache decode path, unrelated
to the glucose service (that is ``repro_torch.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.arch_demo --arch yi-6b --tokens 16
    PYTHONPATH=src python -m repro_torch.launch.arch_demo --device cpu --arch mixtral-8x22b

Builds the reduced variant of ``--arch`` (any registered LM config;
``--full-config`` for the full one), then feeds a prompt of ones token
by token and greedy-decodes ``--tokens`` tokens through ``decode_fn``
from ``init_decode_state``, as the JAX demo does.  Runs on CUDA unless
``--device cpu``; ``glucose-lstm`` (no LM family) exits 2.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.arch import build_arch
from repro_torch.config import get_arch_config, list_archs
from repro_torch.device import resolve_device


def leaf_count(tree) -> int:
    """Elements of every tensor in nested dicts and lists (the hybrid's
    ``blocks`` is a list of dicts)."""
    if isinstance(tree, dict):
        return sum(leaf_count(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(leaf_count(v) for v in tree)
    return tree.numel()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="yi-6b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full (non-reduced) config: needs a large card")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch_config(args.arch)
    if not args.full_config:
        cfg = cfg.reduced()
    try:
        arch = build_arch(cfg)
    except KeyError as err:
        print(f"arch_demo: {err}", file=sys.stderr)
        return 2
    print(f"arch={cfg.name} family={cfg.family} L={cfg.num_layers} d={cfg.d_model}")

    params = arch.init_params(torch.Generator(device=device).manual_seed(0))
    print(f"params: {leaf_count(params) / 1e6:.1f}M")

    b = args.batch
    state = arch.init_decode_state(params, b, args.prompt_len + args.tokens + 8)
    # feed the prompt token by token (prefill-by-decode keeps the demo
    # uniform across cache and state families)
    tok = torch.ones((b, 1), dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    out_tokens = []
    for pos in range(args.prompt_len + args.tokens):
        logits, state = arch.decode_fn(params, state, {"token": tok, "pos": pos})
        tok = torch.argmax(logits[:, -1, : cfg.vocab_size], dim=-1)[:, None].to(torch.int32)
        if pos >= args.prompt_len:
            out_tokens.append(tok[:, 0].cpu().numpy())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    steps = args.prompt_len + args.tokens
    print(f"decoded {args.tokens} tokens (batch {b}) in {dt:.2f}s ({steps / dt:.1f} steps/s)")
    print("sampled token ids:", np.stack(out_tokens, 1).tolist())
    return 0


if __name__ == "__main__":
    sys.exit(main())
