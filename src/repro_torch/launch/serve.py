"""BG-forecast serving entrypoint of the port (the counterpart of
``repro.launch.serve``), end to end on one GPU:

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--checkpoint experiments/checkpoints/gluadfl_ohiot1dm_ring.npz] \
        [--init-hidden 128 --init-seed 0] [--device cuda] \
        [--buckets 1,4,16,64] [--personalize 3 --steps 50] \
        [--requests 256] [--selfcheck]

Lifecycle:

  1. **load** — the federation checkpoint (population params; the LSTM
     width is inferred from the flat parameter count) becomes row 0 of
     the servable's param store.  ``--init-hidden H`` serves freshly
     initialised population params of width H instead, drawn from a
     ``torch.Generator`` seeded with ``--init-seed``;
  2. **personalize** — the LAST ``--personalize`` patients of the
     dataset twin play newly diagnosed arrivals: their first
     ``--history-windows`` training windows fine-tune the population
     model for ``--steps`` steps as one batched call
     (``GlucoseServable.personalize``, plain PyTorch autograd), the
     minibatches drawn from a ``torch.Generator`` on the device seeded
     with ``--seed``; their rows join the param store under their
     patient index and the time prints (0 = population-only serving);
  3. **serve** — a synthetic request stream (random patient, random
     test window; a personalized patient's requests read its own row)
     flows through the ``MicroBatcher`` (pad-to-bucket,
     max-live-batches admission, timeout flush) into the bucketed
     ``forecast`` method, one ``lstm_forward`` launch per batch;
     per-request latency stats print at the end.

``--selfcheck`` additionally asserts that EVERY served forecast,
personalized rows included, bitwise-matches a direct
``model.apply(params_row, window)`` call through the same dispatch —
padding, bucketing and batching must be invisible to the numbers — and
exits 1 on the first mismatch.

``--device`` defaults to ``cuda`` and fails when no GPU is present;
``--device cpu`` runs the kernels' plain twins.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.data import load_federated_dataset
from repro_torch.models import LSTMModel
from repro_torch.serve import GlucoseServable, MicroBatcher, Request, load_population, replay

DEFAULT_CKPT = "experiments/checkpoints/gluadfl_ohiot1dm_ring.npz"


def build_request_stream(fed, servable, n_requests: int, seed: int):
    """A deterministic synthetic stream: each request picks a patient
    (personalized patients by name when present, else the population
    row) and one of that patient's test windows."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n_requests):
        pi = int(rng.integers(0, fed.num_nodes))
        p = fed.patients[pi]
        wi = int(rng.integers(0, len(p.test_x)))
        reqs.append(
            Request(
                rid=rid,
                patient=servable.row_of_or_population(pi),
                window=np.asarray(p.test_x[wi], np.float32),
            )
        )
    return reqs


def personalize_cohort(servable: GlucoseServable, fed, k: int, m: int, seed: int) -> list[int]:
    """The last ``k`` patients of ``fed`` arrive new, each with its first
    ``m`` training windows (zero-padded, ``counts`` marking the real
    ones), and fine-tune as one batched call, drawing from a
    ``torch.Generator`` on the servable's device seeded with ``seed``.
    Prints the time and returns the cohort's patient indices."""
    k = min(k, fed.num_nodes)
    cohort = list(range(fed.num_nodes - k, fed.num_nodes))
    x = np.zeros((k, m, fed.x.shape[-1]), np.float32)
    y = np.zeros((k, m), np.float32)
    counts = np.zeros((k,), np.int64)
    for i, pi in enumerate(cohort):
        p = fed.patients[pi]
        c = min(m, len(p.train_x))
        x[i, :c], y[i, :c], counts[i] = p.train_x[:c], p.train_y[:c], c
    generator = torch.Generator(device=servable.device).manual_seed(seed)
    t0 = time.perf_counter()
    servable.personalize(cohort, x, y, counts, generator=generator)
    if servable.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"personalized {k} cold-start patients ({servable.personalize_steps} steps on "
          f"<= {m} windows each) as one batched call in {dt:.2f}s")
    return cohort


def selfcheck(servable: GlucoseServable, reqs, preds: dict[int, float]) -> int:
    """Count the served forecasts that are not bitwise the direct
    ``model.apply`` of the request's param row (printing each)."""
    bad = 0
    for r in reqs:
        params = {k: v[0] for k, v in servable.params_rows([r.patient]).items()}
        window = torch.as_tensor(r.window, device=servable.device)[None, :]
        direct = float(servable.model.apply(params, window)[0])
        if not (direct == preds[r.rid]):
            bad += 1
            print(f"SELFCHECK MISMATCH rid={r.rid} patient-row={r.patient}: "
                  f"served {preds[r.rid]!r} != direct {direct!r}", file=sys.stderr)
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--checkpoint", default=DEFAULT_CKPT,
                    help="federation checkpoint (.npz from launch/train.py); "
                         "the LSTM width is inferred from the param count")
    ap.add_argument("--hidden", type=int, default=None,
                    help="override the inferred LSTM width")
    ap.add_argument("--init-hidden", type=int, default=None,
                    help="serve freshly initialised population params of "
                         "this width instead of the checkpoint")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="torch.Generator seed for --init-hidden")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a GPU) or 'cpu'")
    ap.add_argument("--dataset", default="ohiot1dm",
                    choices=["ohiot1dm", "abc4d", "ctr3", "replace-bg"])
    ap.add_argument("--full-data", action="store_true",
                    help="full-length synthetic series (default is the "
                         "6-day fast twin — CI scale)")
    ap.add_argument("--buckets", default="1,4,16,64",
                    help="comma-separated padded batch-size buckets")
    ap.add_argument("--max-live-batches", type=int, default=4,
                    help="admission cap: formed-but-unfinished batches")
    ap.add_argument("--flush-timeout-ms", type=float, default=5.0,
                    help="oldest-request wait before a partial batch ships")
    ap.add_argument("--personalize", type=int, default=3,
                    help="how many patients play cold-start arrivals "
                         "(personalized as one batched call; 0 = "
                         "population-only serving)")
    ap.add_argument("--history-windows", type=int, default=24,
                    help="windows of own history each cold-start patient "
                         "brings (small on purpose — newly diagnosed)")
    ap.add_argument("--steps", type=int, default=50,
                    help="fine-tune steps per cold-start patient")
    ap.add_argument("--requests", type=int, default=256,
                    help="synthetic request-stream length")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch-mode", default="map", choices=["map", "vmap"],
                    help="accepted for the JAX launcher's flags; both run "
                         "the same batch-independent kernel")
    ap.add_argument("--selfcheck", action="store_true",
                    help="assert every served forecast bitwise-matches "
                         "direct model.apply; exit 1 on mismatch")
    args = ap.parse_args(argv)

    buckets = tuple(int(b) for b in args.buckets.split(",") if b)
    if args.init_hidden is not None:
        lstm = LSTMModel(hidden=args.init_hidden)
        model, pop = lstm.as_model(), lstm.init(torch.Generator().manual_seed(args.init_seed))
        print(f"population: fresh init, hidden={args.init_hidden}, seed={args.init_seed}")
    else:
        model, pop = load_population(args.checkpoint, hidden=args.hidden)
        print(f"checkpoint {args.checkpoint}")
    n_params = sum(v.numel() for v in pop.values())
    servable = GlucoseServable(model, pop, buckets=buckets, personalize_steps=args.steps,
                               batch_mode=args.batch_mode, device=args.device)
    print(f"{n_params} params on {servable.device}")

    fed = load_federated_dataset(args.dataset, fast=not args.full_data)
    if args.personalize > 0:
        personalize_cohort(servable, fed, args.personalize, args.history_windows, args.seed)
    servable.warmup(history_len=fed.x.shape[-1])
    print(f"warmed {len(servable.compiled_buckets)} buckets: "
          f"{sorted(servable.compiled_buckets)}")
    batcher = MicroBatcher(
        buckets,
        max_live_batches=args.max_live_batches,
        flush_timeout=args.flush_timeout_ms / 1e3,
    )
    reqs = build_request_stream(fed, servable, args.requests, args.seed)
    preds = replay(servable, batcher, reqs)
    stats = batcher.stats()
    print(f"served {stats['completed']} forecasts: "
          f"p50 {stats['p50_latency_ms']:.2f}ms  "
          f"p99 {stats['p99_latency_ms']:.2f}ms  "
          f"{stats['forecasts_per_sec']:.0f} forecasts/sec "
          f"(queue wait {stats['mean_queue_wait_ms']:.2f}ms mean)")
    sample = [round(preds[r] * fed.sd + fed.mean, 1) for r in range(min(4, len(preds)))]
    print(f"first forecasts (mg/dL): {sample}")

    if args.selfcheck:
        bad = selfcheck(servable, reqs, preds)
        if bad:
            print(f"selfcheck FAILED: {bad}/{len(reqs)} forecasts drifted "
                  f"from direct model.apply", file=sys.stderr)
            return 1
        print(f"selfcheck: {len(reqs)}/{len(reqs)} served forecasts "
              f"bitwise-match direct model.apply")
    return 0


if __name__ == "__main__":
    sys.exit(main())
