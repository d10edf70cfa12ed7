"""End-to-end driver: the paper's core experiment -- train population
models on one dataset with GluADFL, evaluate seen and cross-dataset
unseen patients, compare against FedAvg and centralized supervised
learning, then personalize (the counterpart of
``examples/cross_patient.py``).

    python -m repro_torch.examples.cross_patient [--device cpu] [--rounds 300]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core import FedAvg, GluADFL, personalize, train_supervised
from repro_torch.data import load_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.metrics import all_metrics
from repro_torch.models import LSTMModel
from repro_torch.optim import adam
from repro_torch.paper.common import eval_population
from repro_torch.utils.rng import draw_personalize

FINE_TUNE_STEPS, FINE_TUNE_BATCH = 100, 32  # the JAX fine-tune's steps here and batch


def run(argv: list[str] | None = None) -> dict:
    """Train the four models and print their RMSE; returns them by name."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--train-dataset", default="ctr3")
    ap.add_argument("--unseen-dataset", default="abc4d")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    train_fed = load_federated_dataset(args.train_dataset, fast=True)
    unseen_fed = load_federated_dataset(args.unseen_dataset, fast=True, max_patients=8)
    model = LSTMModel(hidden=128).as_model()
    out = {}

    def report(name, params):
        seen, unseen = (eval_population(model, params, f)["rmse"] for f in (train_fed, unseen_fed))
        out[name] = {"seen_rmse": seen, "unseen_rmse": unseen}
        print(f"[{name:8s}] seen {seen:.2f} RMSE | unseen {unseen:.2f} RMSE")

    # --- GluADFL (the paper's method) -------------------------------------
    cfg = FLConfig(topology="random", num_nodes=train_fed.num_nodes,
                   comm_batch=7, rounds=args.rounds)
    glu = GluADFL(model, adam(2e-3), cfg, device=dev)
    pop, _, _ = glu.train(gen(0), train_fed.x, train_fed.y, train_fed.counts, batch_size=64)
    report("gluadfl", pop)

    # --- FedAvg baseline ----------------------------------------------------
    fa = FedAvg(model, adam(2e-3), cfg, device=dev)
    fa_params, _ = fa.train(gen(1), train_fed.x, train_fed.y, train_fed.counts,
                            batch_size=64, rounds=args.rounds // 2)
    report("fedavg", fa_params)

    # --- centralized supervised (the privacy-free upper bound) --------------
    x = np.concatenate([p.train_x for p in train_fed.patients])
    y = np.concatenate([p.train_y for p in train_fed.patients])
    sup, _ = train_supervised(model, adam(2e-3), gen(2), x, y,
                              steps=args.rounds * 2, batch_size=64, device=dev)
    report("mixed", sup)

    # --- personalized-from-population (paper Fig 3) --------------------------
    p0 = train_fed.patients[0]
    rows = len(p0.train_x)
    idx = draw_personalize(gen(3), [rows], rows, FINE_TUNE_STEPS, FINE_TUNE_BATCH)[0]
    pers = personalize(model, adam(5e-4), pop, idx, p0.train_x, p0.train_y)

    def patient_metrics(params):
        with torch.no_grad():
            pred = model.apply(params, torch.as_tensor(p0.test_x, device=dev)).cpu().numpy()
        return all_metrics(p0.test_y_raw, pred * train_fed.sd + train_fed.mean)

    pop_m, per_m = patient_metrics(pop), patient_metrics(pers)
    out["patient0"] = {"population_rmse": pop_m["rmse"], "personalized_rmse": per_m["rmse"]}
    print(f"[patient0] population {pop_m['rmse']:.2f} RMSE -> "
          f"personalized-from-population {per_m['rmse']:.2f} RMSE")
    return out


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
