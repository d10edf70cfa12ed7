#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. card     — ``nvidia-smi`` name and power limit (also printed raw);
  2. build    — compile every CUDA source under ``kernels/csrc`` from the
                checkout, one ``nvcc`` each, in parallel;
  3. kernel   — each kernel against its plain PyTorch twin on the card,
                on distinct seeded per-row weights (max |diff| <= 1e-5,
                TF32 off), and a row's output bitwise independent of the
                batch it was launched in;
  4. serve    — the main path at full width: the REPLACE-BG fast twin
                (N=226 patients), an H=128 population from a seeded
                ``torch.Generator``, buckets 1,4,16,64, 4096 requests
                through ``MicroBatcher`` + ``replay``; every forecast
                bitwise equal to a direct apply and within 1e-5 of the
                plain twin; the kernel's launch count read around it;
  5. narrow   — the committed H=8 checkpoint through the CLI entry point
                (``repro_torch.launch.serve``, width inferred), 256
                requests, ``--selfcheck``;
  6. timing   — at G=64, H=128, L=12 (one serving batch): the kernel,
                its plain twin and cuDNN's LSTM + Linear on the shared
                population weights (the yardstick; the port never calls
                it), CUDA events, median of >= 50 runs after warm-up;
                and the least time the card could take (bytes over
                3.35 TB/s, operations over 67 TFLOP/s fp32);
  7. profile  — ``torch.profiler`` over a replay of 1024 requests: the
                card's busy time and share of the wall time, and the
                largest device items;

then one ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises: the script exits
non-zero and prints no result, as it does when CUDA is absent or when it
stands alone without the repository.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "experiments" / "checkpoints" / "gluadfl_ohiot1dm_ring.npz"
TOL = 1e-5  # fp32 summation order over 12 recurrent steps, H <= 256

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# (G, R, L, I, H): serving shapes (R=1, L=12, I=1) across widths, and
# one multivariate, multi-row, single-step case
CASES = [(1, 1, 12, 1, 8), (37, 1, 12, 1, 32), (64, 1, 12, 1, 128),
         (64, 1, 12, 1, 256), (5, 3, 1, 3, 16)]


def require(cond, what) -> None:
    """Fail the run (an ``assert`` that ``-O`` cannot remove)."""
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def random_inputs(gen: torch.Generator, g, r, steps, isz, hsz):
    """Distinct per-row weights at the model's init scales."""
    def normal(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    return (
        normal(g, r, steps, isz),
        normal(g, isz, 4 * hsz, scale=1 / math.sqrt(isz)),
        normal(g, hsz, 4 * hsz, scale=1 / math.sqrt(hsz)),
        normal(g, 4 * hsz, scale=0.5),
        normal(g, hsz, 1, scale=1 / math.sqrt(hsz)),
        normal(g, 1, scale=0.5),
    )


def time_ms(fn, runs: int, flush: torch.Tensor | None = None) -> float:
    """Median device time of ``fn`` over ``runs`` CUDA-event pairs,
    after warm-up; with ``flush``, the L2 is overwritten before each.
    A spin kernel (~0.2 s) holds the card while the host queues the runs,
    so the events time the card and not the host's launch overhead, as
    long as queueing takes less than the spin (a host-bound ``fn``, such
    as the plain twin's ~9,000 small launches, still times the host)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(350_000_000)  # cycles of the SM clock
    pairs = []
    for _ in range(runs):
        if flush is not None:
            flush.add_(1.0)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def lstm_forward_cost(x, wx, wh, b, w_out, b_out) -> tuple[float, float]:
    """Bytes (each input read once, the output written once) and
    operations of one ``lstm_forward`` call: the gate and head FMAs as 2
    each, the two adds per gate column, and 4 per unit for the c/h
    update (the 5 transcendentals per unit are not counted)."""
    g, r, steps, isz = x.shape
    hsz = wh.shape[1]
    nbytes = 4 * (sum(t.numel() for t in (x, wx, wh, b, w_out, b_out)) + g * r)
    per_step = 2 * (isz + hsz) * 4 * hsz + 2 * 4 * hsz + 4 * hsz
    ops = g * r * (steps * per_step + 2 * hsz + 1)
    return nbytes, ops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data import load_federated_dataset
    from repro_torch.kernels import _build, lstm_cell
    from repro_torch.kernels.ref import lstm_forward_plain
    from repro_torch.launch.serve import build_request_stream, selfcheck
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.models import LSTMModel
    from repro_torch.serve import GlucoseServable, MicroBatcher, replay

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. card ------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    compiled = _build.build()
    ptxas = [ln.strip() for ln in _build.build_log("lstm_forward").splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, compiled=compiled, ptxas=ptxas)

    # 3. kernel vs plain -------------------------------------------------
    gen = torch.Generator().manual_seed(1234)
    errs = []
    for case in CASES:
        inputs = random_inputs(gen, *case)
        y = lstm_cell.lstm_forward(*inputs)
        ref = lstm_forward_plain(*inputs)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        require(y.shape == ref.shape == case[:2] and bool(torch.isfinite(y).all()),
                f"shape or finiteness at {case}")
        require(err <= TOL, f"kernel vs plain at {case}: {err}")
        errs.append(err)
        bitwise = None
        if case[0] == 64:
            row5 = lstm_cell.lstm_forward(*(t[5:6] for t in inputs))
            bitwise = bool(torch.equal(row5[0], y[5]))
            require(bitwise, f"row 5 at G=64 differs from its G=1 launch: {case}")
        emit("kernel", case=dict(zip("GRLIH", case)), max_abs_err=err,
             row5_bitwise_vs_g1=bitwise)

    # 4. full-width serve (the main path) --------------------------------
    fed = load_federated_dataset("replace-bg", fast=True)
    lstm = LSTMModel(hidden=128)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         buckets=(1, 4, 16, 64))

    class CountingBatcher(MicroBatcher):
        def complete(self, batch):
            batches.append(len(batch))
            super().complete(batch)

    batches: list[int] = []
    batcher = CountingBatcher(sv.buckets)
    reqs = build_request_stream(fed, sv, 4096, seed=0)
    lstm_cell.LAUNCHES = 0
    t0 = time.perf_counter()
    sv.warmup(history_len=fed.x.shape[-1])
    preds = replay(sv, batcher, reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lstm_cell.LAUNCHES
    require(launches >= len(batches) > 0, f"{launches} launches for {len(batches)} batches")
    require(sorted(preds) == list(range(len(reqs))), "a request went unanswered")
    served = torch.tensor([preds[r.rid] for r in reqs])
    require(bool(torch.isfinite(served).all()), "non-finite forecast")
    bad = selfcheck(sv, reqs, preds)
    require(bad == 0, f"{bad} served forecasts differ from the direct apply")
    plain_err = 0.0
    for row in sorted({r.patient for r in reqs}):
        mine = [r for r in reqs if r.patient == row]
        params = sv.params_rows([row])
        x = torch.tensor(np.stack([r.window for r in mine]), device="cuda")[None, :, :, None]
        ref = lstm_forward_plain(x, params["wx"], params["wh"], params["b"],
                                 params["w_out"], params["b_out"])[0].cpu()
        got = torch.tensor([preds[r.rid] for r in mine])
        plain_err = max(plain_err, float((got - ref).abs().max()))
    require(plain_err <= TOL, f"served vs plain twin: {plain_err}")
    errs.append(plain_err)
    stats = batcher.stats()
    emit("serve", dataset=fed.name, patients=fed.num_nodes, hidden=128,
         requests=len(reqs), batches=len(batches), full_batches=batches.count(64),
         launches=launches, selfcheck_bitwise=len(reqs) - bad,
         max_abs_err_vs_plain=plain_err, wall_s=wall,
         p50_latency_ms=stats["p50_latency_ms"], p99_latency_ms=stats["p99_latency_ms"],
         forecasts_per_sec=stats["forecasts_per_sec"])

    # 5. narrow serve through the CLI ------------------------------------
    before = lstm_cell.LAUNCHES
    rc = serve_main(["--checkpoint", str(CKPT), "--requests", "256", "--selfcheck",
                     "--device", "cuda"])
    require(rc == 0, f"launch.serve --selfcheck exited {rc}")
    emit("narrow", checkpoint=str(CKPT.relative_to(ROOT)), requests=256,
         launches=lstm_cell.LAUNCHES - before, selfcheck="bitwise")

    # 6. timings at one serving batch: G=64, H=128, L=12 -----------------
    batch = reqs[:64]
    params = sv.params_rows([r.patient for r in batch])
    x = torch.tensor(np.stack([r.window for r in batch]), device="cuda")[:, None, :, None].contiguous()
    inputs = (x, params["wx"], params["wh"], params["b"], params["w_out"], params["b_out"])
    pop = sv.population
    with torch.no_grad():
        cudnn = torch.nn.LSTM(1, 128, batch_first=True).cuda()
        head = torch.nn.Linear(128, 1).cuda()
        cudnn.weight_ih_l0.copy_(pop["wx"].T)
        cudnn.weight_hh_l0.copy_(pop["wh"].T)
        cudnn.bias_ih_l0.copy_(pop["b"])
        cudnn.bias_hh_l0.zero_()
        head.weight.copy_(pop["w_out"].T)
        head.bias.copy_(pop["b_out"])
        xs = x[:, 0].contiguous()

        def library():
            out, _ = cudnn(xs)
            return head(out[:, -1])[:, 0]

        kernel_out = lstm_cell.lstm_forward(*inputs)[:, 0]
        library_err = float((library() - kernel_out).abs().max())
        flush = torch.zeros(64 * 2**20 // 4, device="cuda")  # 64 MB > the 50 MB L2
        ms = time_ms(lambda: lstm_cell.lstm_forward(*inputs), 200)
        ms_flushed = time_ms(lambda: lstm_cell.lstm_forward(*inputs), 200, flush)
        plain_ms = time_ms(lambda: lstm_forward_plain(*inputs), 50)
        library_ms = time_ms(library, 200)
    nbytes, ops = lstm_forward_cost(*inputs)
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = ops / FP32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    bound_by = "bytes" if bound_bytes_ms >= bound_ops_ms else "operations"
    emit("timing", shape=dict(G=64, R=1, L=12, I=1, H=128), ms=ms, ms_l2_flushed=ms_flushed,
         plain_ms=plain_ms, library_ms=library_ms, library="torch.nn.LSTM (cuDNN) + nn.Linear",
         library_max_abs_err=library_err, bytes=nbytes, ops=ops,
         bound_bytes_ms=bound_bytes_ms, bound_ops_ms=bound_ops_ms)

    # 7. where a served batch's time goes --------------------------------
    window = reqs[:1024]
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        replay(sv, MicroBatcher(sv.buckets), window)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        replay(sv, MicroBatcher(sv.buckets), window)
        torch.cuda.synchronize()
    device = {}  # device-side kernels and copies: no host time of their own
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if e.self_cpu_time_total == 0 and us > 0:
            device[e.key] = (e.count, us)
    kernel = [v for k, v in device.items() if "lstm_forward_kernel" in k]
    require(kernel, "the profiler saw no lstm_forward kernel in the serving loop")
    busy_ms = sum(us for _, us in device.values()) / 1e3
    wall_ms = statistics.median(walls) * 1e3
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    emit("profile", requests=len(window), wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms,
         lstm_forward_us_per_launch=kernel[0][1] / kernel[0][0], launches=kernel[0][0],
         top_device=[{"name": k[:80], "count": n, "us": us} for k, (n, us) in top])

    print(json.dumps({"kernels": [{
        "name": "lstm_forward", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/lstm_forward.cu",
        "replaces": "src/repro/kernels/lstm_cell.py:51",
        "launches": launches, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
