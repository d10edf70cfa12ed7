"""``swa_attention``'s two bf16 cluster exchanges at hd 512, timed in one
call on one card at RecurrentGemma-9B's local-attention shape with hd
512 (B=1, S=8,192, H=16, K=1, window 2048), bf16:

  * ahead: the build as it ships (``cluster-wgmma-bf16-hd256x2``: 32-key
    steps, each step's partial scores sent a step ahead);
  * in_place: the same source built with ``-DSWA_AHEAD_CLUSTER=0``, so
    that hd 512 runs the kernel of clusters of 3 to 8 (64-key tiles, the
    partial tiles summed in place between each Q K^T and its softmax);
  * chunked: hd 512 on the scalar hd-256 build in two chunks (the C
    entry's chunk split, which the wrapper takes only above hd 2,048);
  * sdpa: ``chip_smoke.band_sdpa``, the library call the port is held
    against;
  * hd256: the one-block hd-256 build at hd 256, for scale.

Both libraries are compiled with the flags of ``kernels/_build.py``,
held against the plain twin on a small shape (within
``ref.swa_bf16_bound``), and timed: medians of CUDA events over
:data:`REPS` launches after a spin that holds the card while they
queue, in turns (each variant once in order, then in reverse).

    PYTHONPATH=src python tools/swa_cluster_ab.py [--out FILE]

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

from chip_smoke import band_sdpa  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import swa_attention as swa_kernel  # noqa: E402

REPS = 20
SHAPE = dict(B=1, S=8192, H=16, K=1, window=2048)
IN_PLACE = _build.BUILD_DIR / "swa_attention-in-place.so"


def in_place_library() -> ctypes.CDLL:
    """The source built with every cluster summing in place."""
    IN_PLACE.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DSWA_AHEAD_CLUSTER=0", "-o",
                           str(IN_PLACE), str(_build.CSRC / "swa_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(IN_PLACE))


def launcher(lib: ctypes.CDLL, split: int):
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


def inputs(gen, s, h, kh, hd):
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16()
                 for shape in ((1, s, h, hd), (1, s, kh, hd), (1, s, kh, hd)))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    shipped = _build.load("swa_attention")
    calls = {"ahead": launcher(shipped, swa_kernel.CLUSTER),
             "in_place": launcher(in_place_library(), swa_kernel.CLUSTER),
             "chunked": launcher(shipped, swa_kernel.CHUNKS)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = inputs(gen, 1024, 4, 1, 512)
    limit = ref.swa_bf16_bound(q, k, v, window=300)
    o32 = ref.swa_attention_plain(q.float(), k.float(), v.float(), window=300)
    checks = {name: float(((call(q, k, v, 300).float() - o32).abs() / limit).max())
              for name, call in calls.items()}
    if max(checks.values()) > 1.0:
        raise SystemExit(f"over swa_bf16_bound: {checks}")
    s, h, kh, w = (SHAPE[key] for key in ("S", "H", "K", "window"))
    wide, narrow = inputs(gen, s, h, kh, 512), inputs(gen, s, h, kh, 256)
    one_block = launcher(shipped, swa_kernel.ONE_BLOCK)
    runs = {**{name: (lambda call=call: call(*wide, w)) for name, call in calls.items()},
            "sdpa": band_sdpa(*wide, w), "hd256": lambda: one_block(*narrow, w)}
    times: dict[str, list[float]] = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name].append(time_ms(runs[name]))
    medians = {n: statistics.median(t) for n, t in times.items()}
    result = {"card": card, "shape": {**SHAPE, "hd": 512, "dtype": "bfloat16"}, "reps": REPS,
              "ms": times, "ms_median": medians, "max_err_over_bf16_bound": checks,
              "over_sdpa": {n: medians[n] / medians["sdpa"] for n in ("ahead", "in_place")}}
    print(json.dumps(result), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
