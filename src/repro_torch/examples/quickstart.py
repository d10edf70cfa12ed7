"""Quickstart: train a GluADFL population model on a synthetic OhioT1DM
twin and cross-predict an unseen patient (the counterpart of
``examples/quickstart.py``).

    python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.config import FLConfig
from repro_torch.core import GluADFL
from repro_torch.data import load_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.metrics import all_metrics
from repro_torch.models import LSTMModel
from repro_torch.optim import adam


def run(argv: list[str] | None = None) -> dict:
    """Train, cross-predict and print; returns the first and last round
    losses and the unseen patient's metrics."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    # 1. data: 12 synthetic T1D patients (the OhioT1DM twin), windows of
    #    L=12 CGM samples predicting H=6 steps (30 min) ahead
    fed = load_federated_dataset("ohiot1dm", fast=True)
    print(f"{fed.num_nodes} patients, ~{int(fed.counts.mean())} training windows each")

    # 2. hold out patient 11 as UNSEEN (cold start): only 0..10 train
    seen_x, seen_y, seen_counts = fed.x[:11], fed.y[:11], fed.counts[:11]

    # 3. GluADFL: asynchronous decentralized FL over a random topology
    model = LSTMModel(hidden=64).as_model()
    cfg = FLConfig(topology="random", num_nodes=11, comm_batch=7,
                   rounds=100, inactive_ratio=0.3)
    trainer = GluADFL(model, adam(2e-3), cfg, device=dev)
    population, history, _ = trainer.train(
        torch.Generator(device=dev).manual_seed(0), seen_x, seen_y, seen_counts, batch_size=64
    )
    print(f"loss {history[0]['loss']:.3f} -> {history[-1]['loss']:.3f} "
          f"over {cfg.rounds} rounds (30% of nodes inactive per round)")

    # 4. cross-predict the unseen patient with the population model
    unseen = fed.patients[11]
    with torch.no_grad():
        pred = model.apply(population, torch.as_tensor(unseen.test_x, device=dev)).cpu().numpy()
    metrics = all_metrics(unseen.test_y_raw, pred * fed.sd + fed.mean)
    print("UNSEEN patient metrics:", {k: round(v, 2) for k, v in metrics.items()})
    return {"loss_first": history[0]["loss"], "loss_last": history[-1]["loss"], **metrics}


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
