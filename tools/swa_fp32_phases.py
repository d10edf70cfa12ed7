"""Where a tile's time goes in ``swa_attention``'s fp32 one-block kernel
(``swa_attention_kernel_bulk``), on one card.

Builds a copy of ``csrc/swa_attention.cu`` under ``build/`` with
``clock64()`` read at each phase boundary of the tile loop, and has
warp w write its cycle counts over columns 0..7 of its block's output
row w (the copy's output is not attention): the wait for K, Q K^T, K's
release with the softmax and the P write, the wait for V, P V, V's
release, the tiles, and the wait for Q.  ``--mode nostage`` also drops
every wait and copy after the first kStages tiles, which leaves the
products on stale tiles: the time the loop takes with staging free.
Reports each phase's cycles per tile, averaged over the warps of the
blocks whose band is whole, at RecurrentGemma-9B's local attention
(hd 256), the Mistral-Large prefill's heads at hd 128 and the same at hd
64 (S cut to 8,192: the per-tile phases do not depend on S).

    PYTHONPATH=src python tools/swa_fp32_phases.py [--mode full|nostage] [--out FILE]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from repro_torch.kernels import _build  # noqa: E402
from swa_fp32_ab import launcher  # noqa: E402

PHASES = ("wait_k", "qk", "release_k_softmax_p", "wait_v", "pv", "release_v")
SHAPES = {"rg256": (1, 8192, 16, 1, 256, 2048), "prefill128": (1, 8192, 96, 8, 128, 4096),
          "prefill64": (1, 8192, 96, 8, 64, 4096)}


def timed_source(mode: str) -> str:
    """The kernel source with the phase timers (and, in ``nostage``, no
    staging after the first stages)."""
    src = (_build.CSRC / "swa_attention.cu").read_text().replace(
        '#include "hopper.cuh"', f'#include "{_build.CSRC / "hopper.cuh"}"')
    start = src.index("swa_attention_kernel_bulk(const __grid_constant__")
    end = src.index("int launch_bulk(")
    body = src[start:end]

    def sub(old: str, new: str) -> None:
        nonlocal body
        if old not in body:
            raise SystemExit(f"the kernel no longer has: {old!r}")
        body = body.replace(old, new, 1)

    sub("  hopper::mbar_wait(q_full, 0);\n",
        "  long long prof[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long cq = clock64();\n"
        "  hopper::mbar_wait(q_full, 0);\n  prof[7] = clock64() - cq;\n")
    sub("    hopper::mbar_wait(&k_full[s], parity);\n",
        "    long long c0 = clock64();\n    hopper::mbar_wait(&k_full[s], parity);\n"
        "    long long c1 = clock64();\n")
    sub("    bulk_scores<HD>(sc, qs, kst, w, lane);\n",
        "    bulk_scores<HD>(sc, qs, kst, w, lane);\n    long long c2 = clock64();\n")
    sub("    hopper::mbar_wait(&v_full[s], parity);\n",
        "    long long c3 = clock64();\n    hopper::mbar_wait(&v_full[s], parity);\n"
        "    long long c4 = clock64();\n")
    sub("    bulk_pv<HD>(acc, alpha, ps, vst, w, lane);\n",
        "    bulk_pv<HD>(acc, alpha, ps, vst, w, lane);\n    long long c5 = clock64();\n")
    refill_v = ("      stage_rows(vst, &v_map, &v_full[s], L::kTileBytes, g, k0 + kStages * kTile,"
                " b);\n")
    sub(refill_v + "  }\n", refill_v +
        "    long long c6 = clock64();\n"
        "    prof[0] += c1 - c0; prof[1] += c2 - c1; prof[2] += c3 - c2; prof[3] += c4 - c3;\n"
        "    prof[4] += c5 - c4; prof[5] += c6 - c5;\n  }\n  prof[6] = n_tiles;\n")
    close = body.rindex("}")
    body = body[:close] + (
        "  __syncwarp();\n  if (lane == 0) {\n"
        "    float* pr = o + (static_cast<long long>(b) * S * H + h) * HD\n"
        "                + (q0 + w) * static_cast<long long>(H) * HD;\n"
        "    for (int x = 0; x < 8; ++x) pr[x] = static_cast<float>(prof[x]);\n  }\n") + body[close:]
    if mode == "nostage":
        sub("hopper::mbar_wait(&k_full[s], parity);",
            "if (t < kStages) hopper::mbar_wait(&k_full[s], parity);")
        sub("hopper::mbar_wait(&v_full[s], parity);",
            "if (t < kStages) hopper::mbar_wait(&v_full[s], parity);")
        sub("const bool refill = t + kStages < n_tiles;", "const bool refill = false;")
    return src[:start] + body + src[end:]


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mode", choices=("full", "nostage"), default="full")
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    src = _build.BUILD_DIR / f"swa_attention-phases-{args.mode}.cu"
    lib = src.with_suffix(".so")
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(timed_source(args.mode))
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    call = launcher(ctypes.CDLL(str(lib)), 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "mode": args.mode, "phases": PHASES, "shapes": {}}
    for name, (b, s, h, kh, hd, w) in SHAPES.items():
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
        call(q, k, v, w)  # warm-up
        o = call(q, k, v, w)
        torch.cuda.synchronize()
        block = 128 if hd == 128 else 64  # BulkTiles' rows a block
        rows = o.view(b, s // block, block, h, hd)[:, :, :8, :, :8]  # (b, q tile, warp, head, 8)
        whole = (rows[..., 6] == rows[..., 6].max()).unsqueeze(-1).expand_as(rows)
        got = rows[whole].view(-1, 8).double()
        per_tile = got[:, :6].mean(0) / got[:, 6].mean()
        result["shapes"][name] = {
            "shape": dict(B=b, S=s, H=h, K=kh, hd=hd, window=w), "warps": int(got.shape[0]),
            "cycles_per_tile": dict(zip(PHASES, per_tile.tolist())),
            "tile_cycles": float(per_tile.sum()), "q_wait_cycles": float(got[:, 7].mean())}
        del q, k, v, o
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
