"""Topology + asynchrony ablation (the paper's Figs 4-5 in miniature):
the convergence of ring / cluster / random gossip as the inactive-node
ratio rises -- the whole 3x3 grid trained as one batched federation
through ``GluADFL.train_sweep`` -- plus each topology's spectral gap,
the mixing-rate statistic that explains the ordering (the counterpart
of ``examples/topology_async_ablation.py``).

    python -m repro_torch.examples.topology_async_ablation [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core import GluADFL, SweepGrid, mixing_matrix, round_adjacency, spectral_gap
from repro_torch.data import load_federated_dataset
from repro_torch.device import resolve_device
from repro_torch.models import LSTMModel
from repro_torch.optim import adam
from repro_torch.utils.pytree import tree_index

TOPOLOGIES = ("ring", "cluster", "random")
RATIOS = (0.0, 0.5, 0.8)
ROUNDS, HIDDEN = 80, 64


def run(argv: list[str] | None = None) -> dict:
    """Print and return each topology's spectral gap and each scenario's
    val RMSE in mg/dL."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)

    fed = load_federated_dataset("ohiot1dm", fast=True)
    n = fed.num_nodes
    model = LSTMModel(hidden=HIDDEN).as_model()
    vx = torch.as_tensor(np.concatenate([p.val_x for p in fed.patients]), device=dev)
    vy = np.concatenate([p.val_y * fed.sd + fed.mean for p in fed.patients])

    print("spectral gaps (higher = faster gossip mixing):")
    ones = torch.ones(n)
    scores = torch.rand((n, n), generator=torch.Generator().manual_seed(0))
    gaps = {}
    for topo in TOPOLOGIES:
        adj = round_adjacency(topo, n, scores, 7)
        gaps[topo] = spectral_gap(mixing_matrix(adj, ones, 7))
        print(f"  {topo:8s} {gaps[topo]:.4f}")

    # all 9 (topology, inactive-ratio) scenarios train as one batched
    # federation, one seed per scenario, the federation's data shared
    grid = SweepGrid.build(TOPOLOGIES, RATIOS, seeds=(1,), num_nodes=n)
    cfg = FLConfig(num_nodes=n, comm_batch=7, rounds=ROUNDS)
    trainer = GluADFL(model, adam(2e-3), cfg, device=dev)
    pops, _, _ = trainer.train_sweep(fed.x, fed.y, fed.counts, grid=grid, batch_size=64)

    rmse = {}
    for g, (topo, ratio, _) in enumerate(grid.labels):
        with torch.no_grad():
            pred = model.apply(tree_index(pops, g), vx).cpu().numpy() * fed.sd + fed.mean
        rmse[(topo, ratio)] = float(np.sqrt(np.mean((pred - vy) ** 2)))

    for ratio in RATIOS:
        print(f"\ninactive ratio {ratio:.0%}:")
        for topo in TOPOLOGIES:
            print(f"  {topo:8s} val RMSE {rmse[(topo, ratio)]:6.2f}")
    return {"spectral_gap": gaps, "val_rmse": rmse}


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
