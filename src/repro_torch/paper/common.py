"""The paper experiments' shared engine (the counterpart of
``benchmarks/common.py``).

The paper trains for thousands of rounds on months of CGM per patient.
The experiments run the same graph on the synthetic twins at a reduced
:class:`Scale` by default (``--full`` restores the paper's rounds and
patients), so the numbers compare ACROSS methods and topologies (the
paper's claims are relative), not as absolute mg/dL matches.

Everything runs on ``Scale.device`` (default CUDA; a missing GPU
raises, as every entry point of the port does), where each LSTM
population model is evaluated through ``LSTMModel.apply`` -- on CUDA
one ``lstm_forward`` launch per patient's test split.  Results are
written under ``experiments/paper_torch/``, never over the JAX
package's ``experiments/paper/``.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core import FedAvg, GluADFL, train_supervised
from repro_torch.data import load_federated_dataset
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import resolve_device
from repro_torch.metrics import all_metrics
from repro_torch.models import LSTMModel
from repro_torch.optim import adam

DATASETS = ["ohiot1dm", "abc4d", "ctr3", "replace-bg"]

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "paper_torch"


@dataclass
class Scale:
    """Experiment scale knobs (fast defaults vs the paper's scale), and
    the device everything runs on (None: CUDA)."""

    fast: bool = True
    rounds: int = 50
    sup_steps: int = 350
    max_patients: int | None = 8
    hidden: int = 48
    batch_size: int = 64
    seeds: int = 1
    device: str | None = None

    @staticmethod
    def full() -> "Scale":
        return Scale(fast=False, rounds=1000, sup_steps=5000,
                     max_patients=None, hidden=128, seeds=4)

    @property
    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    def generator(self, seed: int) -> torch.Generator:
        """A generator on the scale's device seeded ``seed`` (where the
        JAX experiments take ``PRNGKey(seed)``)."""
        return torch.Generator(device=self.torch_device).manual_seed(seed)


_FED_CACHE: dict = {}


def preload(fed: FederatedData, *, fast: bool = True, max_patients: int | None = None) -> None:
    """Let :func:`load` return ``fed`` for its dataset at a scale of this
    ``fast`` and ``max_patients``, for a caller that holds it already."""
    _FED_CACHE[(fed.name, fast, max_patients)] = fed


def load(dataset: str, scale: Scale) -> FederatedData:
    key = (dataset, scale.fast, scale.max_patients)
    if key not in _FED_CACHE:
        _FED_CACHE[key] = load_federated_dataset(
            dataset, fast=scale.fast, max_patients=scale.max_patients
        )
    return _FED_CACHE[key]


def pooled(fed: FederatedData, split: str):
    """Every patient's ``split`` windows ("train" or "val") concatenated."""
    return (np.concatenate([getattr(p, f"{split}_x") for p in fed.patients]),
            np.concatenate([getattr(p, f"{split}_y") for p in fed.patients]))


def eval_population(model, params, fed: FederatedData) -> dict:
    """Clinical metrics of a population model over a dataset's test
    split: one ``model.apply`` per patient on the params' device (the
    LSTM: one ``lstm_forward`` launch each on CUDA)."""
    dev = next(iter(params.values())).device
    preds, ys = [], []
    for p in fed.patients:
        if len(p.test_x) == 0:
            continue
        with torch.no_grad():
            pred = model.apply(params, torch.as_tensor(p.test_x, device=dev))
        preds.append(pred.cpu().numpy() * fed.sd + fed.mean)
        ys.append(p.test_y_raw)
    return all_metrics(np.concatenate(ys), np.concatenate(preds))


def train_gluadfl(dataset: str, scale: Scale, *, topology: str = "random",
                  inactive_ratio: float = 0.0, seed: int = 0, rounds=None):
    fed = load(dataset, scale)
    model = LSTMModel(hidden=scale.hidden).as_model()
    cfg = FLConfig(
        topology=topology, num_nodes=fed.num_nodes, comm_batch=7,
        rounds=rounds or scale.rounds, inactive_ratio=inactive_ratio, seed=seed,
    )
    tr = GluADFL(model, adam(2e-3), cfg, device=scale.torch_device)
    pop, hist, _ = tr.train(scale.generator(seed), fed.x, fed.y, fed.counts,
                            batch_size=scale.batch_size)
    return model, pop, hist, fed


def train_fedavg(dataset: str, scale: Scale, *, seed: int = 0,
                 engine: str = "scan", chunk: int | None = None):
    fed = load(dataset, scale)
    model = LSTMModel(hidden=scale.hidden).as_model()
    cfg = FLConfig(num_nodes=fed.num_nodes, rounds=scale.rounds, local_steps=2, seed=seed)
    fa = FedAvg(model, adam(2e-3), cfg, device=scale.torch_device)
    params, hist = fa.train(scale.generator(seed), fed.x, fed.y, fed.counts,
                            batch_size=scale.batch_size, engine=engine, chunk=chunk)
    return model, params, hist, fed


def train_mixed_supervised(dataset: str, scale: Scale, *, model_ctor=None,
                           seed: int = 0, engine: str = "scan",
                           chunk: int | None = None):
    fed = load(dataset, scale)
    ctor = model_ctor or (lambda: LSTMModel(hidden=scale.hidden).as_model())
    model = ctor()
    x, y = pooled(fed, "train")
    params, hist = train_supervised(
        model, adam(2e-3), scale.generator(seed), x, y,
        steps=scale.sup_steps, batch_size=scale.batch_size, val=pooled(fed, "val"),
        engine=engine, chunk=chunk, device=scale.torch_device,
    )
    return model, params, hist, fed


def save_json(name: str, payload) -> Path:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    path = OUT_DIR / f"{name}.json"
    path.write_text(json.dumps(payload, indent=2))
    return path


def print_metric_table(title: str, rows: dict[str, dict[str, dict[str, float]]]):
    """rows: {row_label: {col_label: metrics dict}} -- prints paper-style."""
    print(f"\n== {title} ==")
    cols = sorted({c for r in rows.values() for c in r})
    header = "train\\test".ljust(14) + "".join(c.rjust(13) for c in cols)
    print(header)
    for metric in ("rmse", "mard", "mae", "grmse", "time_lag"):
        print(f"-- {metric} --")
        for rl, r in rows.items():
            line = rl.ljust(14)
            for c in cols:
                v = r.get(c, {}).get(metric)
                line += (f"{v:13.2f}" if v is not None else " " * 13)
            print(line)


def parse_scale(argv: list[str] | None, description: str) -> Scale:
    """The experiments' command line: ``--device`` (default CUDA) and
    ``--full`` (the paper's scale)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--full", action="store_true", help="the paper's rounds and patients")
    args = ap.parse_args(argv)
    return replace(Scale.full() if args.full else Scale(), device=args.device)


def main(run: Callable, argv: list[str] | None, description: str) -> int:
    run(parse_scale(argv, description))
    return 0
