"""Phases 23, 25 and 26 of a checkout's ``chip_smoke.py`` alone, on the
card: RecurrentGemma-9B's prefill and decode, the MoE, SSM and enc-dec
families' prefills and decodes, and Granite-MoE-1B-A400M's train step,
each as that checkout's script runs and records it.  Run it once a
checkout, in turns, to compare two commits' single-card LM paths within
one session on one card:

    python tools/phase_ab.py PARENT_ROOT > a1.log
    python tools/phase_ab.py CHANGE_ROOT > b1.log
    python tools/phase_ab.py CHANGE_ROOT > b2.log
    python tools/phase_ab.py PARENT_ROOT > a2.log

A root is a directory holding ``chip_smoke.py`` and ``src/``.  The
script builds the root's kernels, sets the matmul precision that
``chip_smoke.py`` sets, and prints the phases' JSON lines (each with its
``phase`` key) as the script does, then one line ``{"ab_seconds": ...}``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", type=Path)
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sys.path[:0] = [str(root), str(root / "src")]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase_ab: no CUDA device")
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    for phase in (smoke.hybrid_phase, smoke.zoo_phase, smoke.train_phase):
        torch.cuda.empty_cache()
        phase(card)
    print(json.dumps({"ab_seconds": time.perf_counter() - t0, "root": str(root)}), flush=True)


if __name__ == "__main__":
    main()
