"""The paper driver (the counterpart of ``benchmarks/run.py:main``): the
GluADFL round's time, then Tables 2-4 and Figures 3-5, as
``name,us_per_call,derived`` CSV lines.

    python -m repro_torch.paper.run [--device cpu] [--quick] [--full]

The experiments run on the synthetic twins at a reduced scale by
default (``--quick`` smaller still, ``--full`` the paper's rounds), on
``--device`` (default CUDA).  Two parts of the JAX driver are not
ported and print no number: ``bench_kernels`` (the Pallas kernels'
micro-benchmarks; the CUDA kernels are timed by ``chip_smoke.py``) and
``summarize_roofline`` (the TPU pod's dry-run roofline).
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import torch

from repro_torch.config import FLConfig
from repro_torch.core import GluADFL
from repro_torch.models import LSTMModel
from repro_torch.optim import adam
from repro_torch.paper import (
    fig3_personalization,
    fig4_topology,
    fig5_async,
    table2_generalization,
    table3_supervised,
    table4_baselines,
)
from repro_torch.paper.common import Scale, load

NOT_PORTED = ("# not ported: bench_kernels (the Pallas micro-benchmarks) and "
              "summarize_roofline (the TPU dry-run roofline)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_fl_round(device=None, reps: int = 10) -> list[str]:
    """GluADFL round time on OhioT1DM (the training loop's hot path):
    ``reps`` rounds, draws included, after one warm-up round, ending in
    a sync."""
    scale = Scale(device=device)
    dev = scale.torch_device
    fed = load("ohiot1dm", scale)
    model = LSTMModel(hidden=scale.hidden).as_model()
    lines = []
    for topo in ("ring", "random"):
        cfg = FLConfig(topology=topo, num_nodes=fed.num_nodes, rounds=5, comm_batch=7)
        tr = GluADFL(model, adam(2e-3), cfg, device=dev)
        gen = scale.generator(0)
        state = tr.init(gen)
        data = tr.to_device(fed.x, fed.y, fed.counts)
        state, _ = tr.round(state, data, tr.draw(gen, data, 64))  # warm-up
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            state, _ = tr.round(state, data, tr.draw(gen, data, 64))
        _sync(dev)
        us = (time.perf_counter() - t0) / reps * 1e6
        lines.append(f"fl.gluadfl_round.{topo},{us:.0f},nodes={fed.num_nodes}")
    return lines


def drive(argv: list[str] | None = None) -> dict:
    """Parse ``argv``, print the CSV lines and return every experiment's
    result by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true", help="reduced tables")
    ap.add_argument("--full", action="store_true", help="paper-scale rounds")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    scale = Scale.full() if args.full else Scale()
    if args.quick:
        scale = Scale(rounds=20, sup_steps=150, max_patients=6, hidden=32)
    scale = replace(scale, device=args.device)
    out = {}

    print("name,us_per_call,derived")
    print(NOT_PORTED)
    for line in bench_fl_round(args.device):
        print(line)

    t0 = time.time()
    out["table2"] = s2 = table2_generalization.run(scale)
    print(f"table2.generalization,{(time.time()-t0)*1e6:.0f},"
          f"mean_unseen_gap_rmse={s2['mean_unseen_minus_seen_rmse']:.3f}")

    t0 = time.time()
    out["table3"] = table3_supervised.run(scale)
    print(f"table3.supervised,{(time.time()-t0)*1e6:.0f},ok")

    t0 = time.time()
    datasets = ["ohiot1dm", "abc4d"] if args.quick else None
    out["table4"] = table4_baselines.run(scale, datasets=datasets)
    print(f"table4.baselines,{(time.time()-t0)*1e6:.0f},ok")

    # figures: 2 datasets by default (all 4 with --full; 1 with --quick)
    fig_ds = (["ohiot1dm"] if args.quick
              else None if args.full else ["ohiot1dm", "abc4d"])
    t0 = time.time()
    out["fig3"] = fig3_personalization.run(scale, datasets=fig_ds)
    print(f"fig3.personalization,{(time.time()-t0)*1e6:.0f},ok")

    t0 = time.time()
    out["fig4"] = fig4_topology.run(scale, datasets=fig_ds)
    print(f"fig4.topology,{(time.time()-t0)*1e6:.0f},ok")

    t0 = time.time()
    out["fig5"] = fig5_async.run(scale, datasets=fig_ds,
                                 ratios=[0.0, 0.5, 0.9] if args.quick
                                 else [0.0, 0.3, 0.7, 0.9] if not args.full else None)
    print(f"fig5.async,{(time.time()-t0)*1e6:.0f},ok")
    return out


def main(argv: list[str] | None = None) -> int:
    drive(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
