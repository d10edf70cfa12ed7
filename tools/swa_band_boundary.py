"""Where ``swa_attention``'s band build beats the cluster builds: both
timed in one call on one card at RecurrentGemma-9B's local-attention
shape with the head dim widened (B=1, S=8,192, H=16, K=1, window 2048),
at every hd = 256 c for 2 <= c <= 8 in fp32 and bf16:

  * cluster: the thread-block cluster build of c CTAs, through that
    source's ``swa_attention_launch`` at its cluster split (1);
  * band: the two passes through the banded score workspace, through
    ``kernels/swa_attention.py:_launch_band``;
  * sdpa: ``chip_smoke.band_sdpa``, the library call the port is held
    against;

and at fp32 hd 256 the band build beside the one-block build
(``scalar-fp32-hd256``) and SDPA.

The cluster builds were removed from the source once the band took
every hd they ran, so ``--cluster-from`` names a directory that holds
the ``swa_attention.cu`` and ``hopper.cuh`` of a commit that still has
them (the parent of the commit that removed them); the tool builds that
source with the flags of ``kernels/_build.py`` beside the shipped
library, which runs the band and the one-block builds:

    git archive <commit> src/repro_torch/kernels/csrc | tar -x -C build/ab
    PYTHONPATH=src python tools/swa_band_boundary.py \\
        --cluster-from build/ab/src/repro_torch/kernels/csrc [--out FILE]

Each band output is held against the build it would replace (fp32:
within 3e-5 of it; bf16: both within ``ref.swa_bf16_bound`` of the fp32
banded path), and two band launches must agree bitwise.  Times are CUDA
events over :data:`REPS` launches a round after a spin that holds the
card while they queue, in two rounds (each variant once in order, then
in reverse): the median and the spread (least and most) of the
2 x :data:`REPS` launches.  ``bound_ms`` is ``chip_smoke.py``'s bound.

Prints one JSON line a case, then the card's name and power limit;
writes the whole result to ``--out`` when given.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from chip_smoke import BF16_OPS_PER_S, FP32_OPS_PER_S, band_sdpa, bound, swa_cost  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import swa_attention as swa_kernel  # noqa: E402
from repro_torch.nn import attention as attn  # noqa: E402
from swa_fp32_ab import launcher  # noqa: E402

REPS = 10
TOL = 3e-5
SHAPE = dict(B=1, S=8192, H=16, K=1, window=2048)
HDS = tuple(256 * c for c in range(2, 9))
CLUSTER = 1  # the cluster split of the C entry that still has the cluster builds


def cluster_library(src: Path) -> ctypes.CDLL:
    """The C entry of ``src/swa_attention.cu``, built beside the shipped
    library."""
    digest = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode())
    for path in [src / "swa_attention.cu", *sorted(src.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    out = _build.BUILD_DIR / f"swa_attention-cluster-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                               str(src / "swa_attention.cu")], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def band(q, k, v, window):
    out = torch.empty_like(q)
    err = swa_kernel._launch_band(q, k, v, out, window=window, scale=q.shape[-1] ** -0.5,
                                  stream=torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the band build failed to launch: cudaError {err}")
    return out


def event_ms(fn) -> list[float]:
    """:data:`REPS` launches' CUDA-event times, after three warm-up calls."""
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
    return [a.elapsed_time(b) for a, b in pairs]


def timed(runs: dict, costs: tuple[float, float], ops_per_s: float) -> dict:
    """The runs in two rounds (in order, then in reverse): each one's
    median and spread over both rounds' launches, its share of the bound."""
    times: dict[str, list[float]] = {name: [] for name in runs}
    for name in list(runs) + list(runs)[::-1]:
        times[name] += event_ms(runs[name])
    bound_ms, bound_by = bound(*costs, ops_per_s)
    row = {"bound_ms": bound_ms, "bound_by": bound_by}
    for name, t in times.items():
        med = statistics.median(t)
        row[name] = {"ms": med, "min_ms": min(t), "max_ms": max(t), "bound_share": bound_ms / med}
    return row


def case(gen, hd: int, dtype: torch.dtype, rival: str, rival_call) -> dict:
    """One (dtype, hd): the band against ``rival`` (the build it would
    replace) and SDPA, checked and timed."""
    b, s, h, kh, w = (SHAPE[key] for key in ("B", "S", "H", "K", "window"))
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for shape in ((b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    got, want = band(q, k, v, w), rival_call(q, k, v, w)
    check = {"bitwise_repeat": bool(torch.equal(got, band(q, k, v, w))),
             "band_vs_rival_max_abs_diff": float((got.float() - want.float()).abs().max())}
    if dtype == torch.float32:
        ok = check["band_vs_rival_max_abs_diff"] <= TOL
    else:
        banded = attn.banded_flash_attention(q.float(), k.float(), v.float(), window=w)
        limit = ref.swa_bf16_bound(q, k, v, window=w, attention=attn.banded_flash_attention)
        check.update({f"{name}_max_err_over_bound": float(((x.float() - banded).abs()
                                                           / limit).max())
                      for name, x in (("band", got), (rival, want))})
        ok = max(check["band_max_err_over_bound"], check[f"{rival}_max_err_over_bound"]) <= 1.0
        del banded, limit
    del got, want
    if not (ok and check["bitwise_repeat"]):
        raise SystemExit(f"hd {hd} {dtype}: the band disagrees with {rival}: {check}")
    runs = {rival: lambda: rival_call(q, k, v, w), "band": lambda: band(q, k, v, w),
            "sdpa": band_sdpa(q, k, v, w)}
    row = {"hd": hd, "dtype": str(dtype).removeprefix("torch."), "check": check,
           **timed(runs, swa_cost(q, k, w),
                   BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S)}
    row["band_over_" + rival] = row["band"]["ms"] / row[rival]["ms"]
    print(json.dumps(row), flush=True)
    del q, k, v, runs
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path)
    parser.add_argument("--cluster-from", type=Path, required=True,
                        help="a directory with the swa_attention.cu that has the cluster builds")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    cluster = launcher(cluster_library(args.cluster_from), CLUSTER)
    one_block = launcher(_build.load("swa_attention"), swa_kernel.ONE_BLOCK)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = [case(gen, 256, torch.float32, "one_block", one_block)]
    rows += [case(gen, hd, dtype, "cluster", cluster)
             for dtype in (torch.float32, torch.bfloat16) for hd in HDS]
    result = {"card": card, "shape": SHAPE, "reps_a_round": REPS, "rounds": 2, "tol": TOL,
              "cluster_from": str(args.cluster_from), "rows": rows}
    print(json.dumps({"card": card}), flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
