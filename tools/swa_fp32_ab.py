"""``swa_attention``'s fp32 one-block builds, timed in one call on one card:

  * RecurrentGemma-9B's local attention (B=1, S=8,192, H=16, K=1, window
    2048) at its hd 256: the build as it ships (``scalar-fp32-hd256``,
    ``swa_attention_kernel_bulk``) against the code it replaced, which the C
    entry still runs as the chunked build at one chunk (the ``CHUNKS``
    split at hd 256, which the wrapper never sends);
  * the Mistral-Large prefill's shape (B=1, S=32,768, H=96, K=8, window
    4096) at its hd 128 (``scalar-fp32-hd128``) beside banded SDPA in
    fp32 (``chip_smoke.band_sdpa``, the library call the port is held
    against);
  * the same shape at hd 64 (``scalar-fp32-hd64``), a synthetic shape (no
    config has it at full width; every reduced config runs hd 64), beside
    SDPA in fp32.

Each build, and the replaced code at hd 256, is first held against the
plain twin on small shapes (within 3e-5, the fp32 checks' bound).
Times are medians of CUDA events over :data:`REPS` launches after a spin
that holds the card while they queue, in turns (each variant once in
order, then in reverse); ``bound_ms`` is the least time at 67 TFLOP/s of
fp32 FMAs, as ``chip_smoke.py`` counts it.

    PYTHONPATH=src python tools/swa_fp32_ab.py [--out FILE]

Prints one JSON object, and writes it to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import FP32_OPS_PER_S, band_sdpa, bound, swa_cost  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import swa_attention as swa_kernel  # noqa: E402

REPS = 20
TOL = 3e-5
RG = dict(B=1, S=8192, H=16, K=1, window=2048, hd=256)
PREFILL = dict(B=1, S=32768, H=96, K=8, window=4096)
CHECKS = ((1, 320, 16, 1, 256, 2048), (2, 192, 4, 2, 256, 100), (1, 1024, 12, 1, 128, 300),
          (2, 192, 4, 1, 64, 100), (1, 64, 2, 2, 64, 1))


def launcher(lib: ctypes.CDLL, split: int):
    """``swa_attention_launch`` of ``lib`` at one split: ``call(q, k, v,
    window)`` on the current stream, scale hd^-0.5, raising on a failed
    launch."""
    fn = lib.swa_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, window):
        b, s, h, hd = q.shape
        out = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, k.shape[2],
                 hd, window, hd ** -0.5, int(q.dtype == torch.bfloat16), split,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with cudaError {err}")
        return out
    return call


def time_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(350_000_000)  # holds the card while the launches queue
    pairs = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def inputs(gen, b, s, h, kh, hd):
    return tuple(torch.randn(shape, generator=gen, device="cuda")
                 for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))


def group(runs: dict, costs: tuple[float, float]) -> dict:
    """The runs timed in turns, with the bound of their shared work."""
    times: dict[str, list[float]] = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(time_ms(runs[name]))
    medians = {n: statistics.median(t) for n, t in times.items()}
    bound_ms, bound_by = bound(*costs, FP32_OPS_PER_S)
    return {"ms": times, "ms_median": medians, "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": {n: bound_ms / t for n, t in medians.items()}}


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    lib = _build.load("swa_attention")
    build, replaced = launcher(lib, swa_kernel.ONE_BLOCK), launcher(lib, swa_kernel.CHUNKS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = []
    for b, s, h, kh, hd, w in CHECKS:
        q, k, v = inputs(gen, b, s, h, kh, hd)
        want = ref.swa_attention_plain(q, k, v, window=w)
        got = build(q, k, v, w)
        row = {"shape": [b, s, h, kh, hd, w], "max_abs_err": float((got - want).abs().max()),
               "bitwise_repeat": bool(torch.equal(got, build(q, k, v, w)))}
        if hd == 256:
            row["replaced_max_abs_err"] = float((replaced(q, k, v, w) - want).abs().max())
        checks.append(row)
    if any(c["max_abs_err"] > TOL or c.get("replaced_max_abs_err", 0.0) > TOL
           or not c["bitwise_repeat"] for c in checks):
        raise SystemExit(f"over {TOL} or not bitwise on repeat: {checks}")

    w = RG["window"]
    rg = inputs(gen, RG["B"], RG["S"], RG["H"], RG["K"], RG["hd"])
    result = {"card": card, "reps": REPS, "tol": TOL, "checks": checks,
              "hd256_rg": {"shape": RG, **group(
                  {"build": lambda: build(*rg, w), "replaced": lambda: replaced(*rg, w)},
                  swa_cost(rg[0], rg[1], w))}}
    del rg
    w = PREFILL["window"]
    for hd in (128, 64):
        x = inputs(gen, PREFILL["B"], PREFILL["S"], PREFILL["H"], PREFILL["K"], hd)
        sdpa = band_sdpa(*x, w)
        err = float((sdpa().transpose(1, 2) - build(*x, w)).abs().max())
        key = "hd128_prefill" if hd == 128 else "hd64_prefill_synthetic"
        result[key] = {"shape": {**PREFILL, "hd": hd}, "sdpa_max_abs_err": err,
                       **group({"build": lambda: build(*x, w), "sdpa": sdpa},
                               swa_cost(x[0], x[1], w))}
        del x, sdpa
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
