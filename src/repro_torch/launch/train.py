"""Federated training launcher, the paper's experiment end to end, on
one process (the counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --dataset replace-bg --topology random --rounds 200 \\
        [--mixer kernel] [--eval-every 16] [--device cpu] \\
        [fl.comm_batch=7 train.lr=1e-3 ...]

Loads the synthetic-twin dataset, trains GluADFL, prints the population
model's clinical metrics per patient and in aggregate, and writes the
population params as ``<out>/gluadfl_<dataset>_<topology>.npz`` in the
JAX launcher's format (flat ``vec`` plus ``meta``), which both
packages' ``load_population`` read.

  * ``--device`` (default ``cuda``) raises without a GPU unless ``cpu``;
  * ``--mixer tree`` mixes with plain PyTorch, ``--mixer kernel`` with
    the hand-written CUDA kernels (their plain twins on the CPU);
  * ``--gossip-repr auto`` (default) picks the sparse neighbor table
    once N >= 4 (B+1): sparse at replace-bg's N=226, dense at
    ohiot1dm's N=12;
  * ``--gossip-impl masked`` adds pairwise-masked secure aggregation
    (``core.secure_agg``; bitwise the unmasked run from the same seed);
    ``allgather`` (default) and ``auto`` mix plainly;
  * ``--chunk K`` rounds between host syncs (0 = every round, as
    ``--engine loop``); ``--eval-every K`` adds the population's val
    RMSE every K rounds.

Scenario sweeps: ``--sweep-ratios 0,0.3,0.7 --sweep-seeds 3`` trains
the (ratio x seed) grid of ``--topology`` as one batched federation
(``GluADFL.train_sweep``); ``--sweep-schedules bernoulli,markov``,
``--sweep-skews 0,0.5`` and ``--sweep-dp-sigmas 0.01,0.05`` extend the
cross product, and need ``--sweep-ratios``.  Sweeps run the tree mixer
and sync with the host once per chunk (``--mixer kernel``,
``--engine loop`` and ``--chunk 0`` exit 2).  Each scenario's test forecasts are one forward
of the G population models per patient; instead of a checkpoint, the
launcher writes the per-scenario summary
``<out>/sweep_<dataset>_<topology>.json``, the JAX launcher's records.

Not ported yet, and refused with exit code 2: multi-host runs,
``--mixer sharded``, the sharded schedules ``--gossip-impl psum`` and
``gather``, and the deprecated ``--use-kernel``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, replace
from pathlib import Path

import numpy as np
import torch

from repro_torch.config import ExperimentConfig, apply_overrides
from repro_torch.core import (
    GluADFL,
    GossipPlanError,
    SweepGrid,
    choose_gossip_impl,
    choose_gossip_repr,
)
from repro_torch.data import load_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.metrics import all_metrics
from repro_torch.models import LSTMModel
from repro_torch.optim import get_optimizer
from repro_torch.utils.pytree import tree_to_vector

# flags of the JAX launcher whose paths are not ported: any use exits 2
NOT_PORTED_FLAGS = ("--coordinator", "--num-processes", "--process-id", "--use-kernel")
NOT_PORTED_REASON = "multi-host runs and the deprecated --use-kernel"


def save_checkpoint(path: Path, params: dict[str, torch.Tensor]) -> None:
    """The JAX launcher's format: ``vec`` (leaves in sorted-key order)
    and ``meta``, a JSON list of (index, shape, dtype) per leaf."""
    vec = tree_to_vector(params).detach().cpu().numpy().astype(np.float32)
    meta = [(str(i), list(params[k].shape), "float32") for i, k in enumerate(sorted(params))]
    np.savez(path, vec=vec, meta=json.dumps(meta))


def val_windows(fed, total: int = 2048):
    """The streaming eval's validation set: the first
    ``total // N`` val windows of every patient, concatenated."""
    cap = max(1, total // fed.num_nodes)
    return (np.concatenate([p.val_x[:cap] for p in fed.patients]),
            np.concatenate([p.val_y[:cap] for p in fed.patients]))


def patient_predictions(model, pops, fed, device):
    """Yield ``(patient, (G, R) mg/dL predictions)`` of G population
    models (leaves (G, ...); G=1 for a single run) over each patient's
    test split: one forward of the G models a patient."""
    for p in fed.patients:
        x = torch.as_tensor(p.test_x, dtype=torch.float32, device=device)
        with torch.no_grad():
            pred = model.apply_groups(pops, x).cpu().numpy()
        yield p, pred * fed.sd + fed.mean


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", default="ohiot1dm",
                    choices=["ohiot1dm", "abc4d", "ctr3", "replace-bg"])
    ap.add_argument("--topology", default="random",
                    choices=["ring", "cluster", "random", "star", "full"])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--inactive-ratio", type=float, default=0.0)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--fast-data", action="store_true", help="6-day synthetic series (CI scale)")
    ap.add_argument("--mixer", default="tree", choices=["tree", "kernel", "sharded"],
                    help="gossip mixer: tree (plain PyTorch) or kernel (CUDA kernels)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="rounds between host syncs; 0 = every round (the loop engine)")
    ap.add_argument("--engine", default="scan", choices=["scan", "loop"],
                    help="loop = sync every round, as --chunk 0")
    ap.add_argument("--sweep-ratios", default=None,
                    help="comma-separated inactive ratios, e.g. '0,0.3,0.7': train the "
                         "(ratio x seed) grid of --topology as one batched federation")
    ap.add_argument("--sweep-seeds", type=int, default=1,
                    help="seeds per sweep scenario (0..K-1); only with --sweep-ratios")
    ap.add_argument("--sweep-schedules", default=None,
                    help="comma-separated schedules from {bernoulli, markov}; only with "
                         "--sweep-ratios")
    ap.add_argument("--sweep-skews", default=None,
                    help="comma-separated non-IID data-skew strengths; only with --sweep-ratios")
    ap.add_argument("--sweep-dp-sigmas", default=None,
                    help="comma-separated local-DP gossip sigmas; only with --sweep-ratios")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="population val RMSE every K rounds (0 = off)")
    ap.add_argument("--gossip-impl", default="allgather",
                    choices=["allgather", "psum", "masked", "gather", "auto"])
    ap.add_argument("--gossip-repr", default="auto", choices=["dense", "sparse", "auto"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default="experiments/checkpoints")
    ap.add_argument("overrides", nargs="*", help="cfg overrides a.b=c")
    return ap


@dataclass
class TrainRun:
    """What one launch produced, for callers that drive :func:`run`.  A
    sweep's ``population`` has (G, ...) leaves, its ``history`` holds
    G lists, ``checkpoint`` is its summary JSON and ``summary`` its
    records."""

    trainer: GluADFL
    population: dict
    history: list
    checkpoint: Path
    seconds: float
    summary: list | None = None


class Refused(Exception):
    """A flag or knob whose path is not ported (exit code 2)."""


def main(argv: list[str] | None = None) -> int:
    try:
        run(argv)
    except Refused as e:
        print(f"repro_torch.launch.train: {e}", file=sys.stderr)
        return 2
    return 0


def run(argv: list[str] | None = None) -> TrainRun:
    """Parse ``argv``, train, report and write the checkpoint."""
    argv = sys.argv[1:] if argv is None else list(argv)
    for arg in argv:
        if arg.split("=")[0] in NOT_PORTED_FLAGS:
            raise Refused(f"{arg.split('=')[0]} is not ported to PyTorch yet "
                          f"({NOT_PORTED_REASON}; use --mixer kernel)")
    args = build_parser().parse_args(argv)
    if args.mixer == "sharded":
        raise Refused("--mixer sharded is not ported to PyTorch yet; use tree or kernel")
    sweep_ratios, sweep_axes = parse_sweep(args)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = apply_overrides(ExperimentConfig(), args.overrides)
    fed = load_federated_dataset(args.dataset, fast=args.fast_data,
                                 history_len=cfg.data.history_len, horizon=cfg.data.horizon)
    print(f"dataset={args.dataset} nodes={fed.num_nodes} windows/node~{int(fed.counts.mean())}")
    lstm = LSTMModel(history_len=cfg.data.history_len, hidden=args.hidden)
    fl_cfg = replace(cfg.fl, topology=args.topology, num_nodes=fed.num_nodes,
                     rounds=args.rounds, inactive_ratio=args.inactive_ratio)
    gossip_repr = args.gossip_repr
    if gossip_repr == "auto":
        gossip_repr = choose_gossip_repr(fed.num_nodes, fl_cfg.comm_batch)
        print(f"gossip-repr auto -> {gossip_repr}")
    gossip_impl = args.gossip_impl
    if gossip_impl == "auto":
        gossip_impl = choose_gossip_impl()
        print(f"gossip-impl auto -> {gossip_impl}")
    try:
        trainer = GluADFL(lstm.as_model(), get_optimizer(cfg.train.optimizer, cfg.train.lr),
                          fl_cfg, mixer=args.mixer, gossip_impl=gossip_impl,
                          gossip_repr=gossip_repr, device=device)
    except GossipPlanError as e:
        raise Refused(str(e)) from e
    print(f"gossip-impl {trainer.plan.gossip_impl}")

    val_data = None
    if args.eval_every:
        val_data = val_windows(fed)
        print(f"streaming eval: every {args.eval_every} rounds on {len(val_data[0])} val windows")

    if sweep_ratios is not None:
        grid = SweepGrid.build([args.topology], sweep_ratios, range(args.sweep_seeds),
                               num_nodes=fed.num_nodes, cluster_size=fl_cfg.cluster_size,
                               **sweep_axes)
        return run_sweep(args, trainer, grid, sweep_ratios, sweep_axes, fed, cfg, val_data,
                         device)

    generator = torch.Generator(device=device).manual_seed(fl_cfg.seed)
    t0 = time.perf_counter()
    pop, hist, _ = trainer.train(
        generator, fed.x, fed.y, fed.counts, batch_size=cfg.train.batch_size,
        chunk=1 if args.chunk == 0 or args.engine == "loop" else args.chunk,
        eval_every=args.eval_every, val_data=val_data,
    )
    seconds = time.perf_counter() - t0
    print(f"round 0 loss {hist[0]['loss']:.4f} -> round {len(hist) - 1} "
          f"loss {hist[-1]['loss']:.4f}  ({len(hist) / seconds:.2f} rounds/s on {device})")
    evals = [h for h in hist if "val_rmse" in h]
    if evals:
        print("val RMSE (normalized): " + "  ".join(
            f"r{h['round']}={h['val_rmse']:.4f}" for h in evals[-5:]))

    preds, ys = [], []
    single = {k: v[None] for k, v in pop.items()}
    for i, (p, (pred,)) in enumerate(patient_predictions(lstm, single, fed, device)):
        m = all_metrics(p.test_y_raw, pred)
        print(f"  patient {i:3d}: RMSE {m['rmse']:6.2f}  MARD {m['mard']:5.2f}%  "
              f"gRMSE {m['grmse']:6.2f}  lag {m['time_lag']:4.1f}min")
        preds.append(pred)
        ys.append(p.test_y_raw)
    agg = all_metrics(np.concatenate(ys), np.concatenate(preds))
    print("population:", {k: round(v, 2) for k, v in agg.items()})

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    ckpt = out / f"gluadfl_{args.dataset}_{args.topology}.npz"
    save_checkpoint(ckpt, pop)
    print(f"checkpoint -> {ckpt}")
    return TrainRun(trainer, pop, hist, ckpt, seconds)


def parse_sweep(args) -> tuple[list[float] | None, dict]:
    """The sweep flags: the ratios (None when no sweep is asked for) and
    the armed optional axes; the JAX launcher's refusals, exit 2."""
    if args.sweep_ratios is None:
        if args.sweep_schedules or args.sweep_skews or args.sweep_dp_sigmas:
            raise Refused("--sweep-schedules/--sweep-skews/--sweep-dp-sigmas extend the "
                          "scenario grid and need --sweep-ratios")
        return None, {}
    ratios = [float(r) for r in args.sweep_ratios.split(",") if r]
    if not ratios:
        raise Refused("--sweep-ratios parsed to an empty list")
    if args.sweep_seeds < 1:
        raise Refused("--sweep-seeds must be >= 1")
    axes = {}
    if args.sweep_schedules:
        axes["schedules"] = tuple(v.strip() for v in args.sweep_schedules.split(",") if v.strip())
    if args.sweep_skews:
        axes["skews"] = tuple(float(v) for v in args.sweep_skews.split(",") if v)
    if args.sweep_dp_sigmas:
        axes["dp_sigmas"] = tuple(float(v) for v in args.sweep_dp_sigmas.split(",") if v)
    if args.mixer == "kernel":
        raise Refused("scenario sweeps batch the tree mixer; the kernel mixer is "
                      "per-scenario (drop --mixer kernel)")
    if args.engine == "loop" or args.chunk == 0:
        raise Refused("scenario sweeps need the scan engine (drop --engine loop / --chunk 0)")
    return ratios, axes


def run_sweep(args, trainer: GluADFL, grid: SweepGrid, ratios: list[float], sweep_axes: dict,
              fed, cfg, val_data, device) -> TrainRun:
    """Train the grid, print each scenario's test metrics and write the
    summary records (the JAX launcher's keys)."""
    axes_note = "".join(f" x {k} {list(v)}" for k, v in sweep_axes.items())
    print(f"sweep: {grid.size} scenarios ({args.topology} x {ratios}{axes_note} x "
          f"{args.sweep_seeds} seeds) as one batched program")
    t0 = time.perf_counter()
    pops, hists, _ = trainer.train_sweep(
        fed.x, fed.y, fed.counts, grid=grid, batch_size=cfg.train.batch_size,
        chunk=args.chunk or None, eval_every=args.eval_every, val_data=val_data)
    seconds = time.perf_counter() - t0
    print(f"{grid.size * len(hists[0]) / seconds:.2f} scenario-rounds/s on {device}")
    preds, ys = [], []
    for p, pred in patient_predictions(trainer.model, pops, fed, device):
        preds.append(pred)
        ys.append(p.test_y_raw)
    ys = np.concatenate(ys)
    summary = []
    for g in range(grid.size):
        lab = grid.label_dict(g)
        hist = hists[g]
        agg = all_metrics(ys, np.concatenate([pred[g] for pred in preds]))
        rec = {**lab, "final_loss": hist[-1]["loss"], **agg}
        evals = [h["val_rmse"] for h in hist if "val_rmse" in h]
        if evals:
            rec["final_val_rmse"] = evals[-1]
        summary.append(rec)
        extra = ""
        if sweep_axes:
            extra = f" sched={lab['schedule']} skew={lab['skew']:g} dp={lab['dp_sigma']:g}"
        print(f"  [{lab['topology']:8s} inactive={lab['inactive_ratio']:.0%} "
              f"seed={lab['seed']}{extra}] loss {rec['final_loss']:.4f}  "
              f"test RMSE {agg['rmse']:6.2f}  MARD {agg['mard']:5.2f}%")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"sweep_{args.dataset}_{args.topology}.json"
    path.write_text(json.dumps(summary, indent=2))
    print(f"sweep summary -> {path}")
    return TrainRun(trainer, pops, hists, path, seconds, summary)


if __name__ == "__main__":
    sys.exit(main())
