"""Figure 5: robustness to the inactive-node ratio per topology -- the
paper's asynchrony (wait-free) experiment: stable up to ~70% inactive,
the random topology most robust.  The counterpart of
``benchmarks/fig5_async.py``.

Default path: the whole (topology x inactive-ratio x seed) grid trains
as one batched federation through ``GluADFL.train_sweep``, then each
scenario's population is evaluated on the test split by
``paper.common.eval_population`` (on CUDA one ``lstm_forward`` launch a
patient, so N x G launches).  ``--serial`` (or ``run(serial=True)``)
trains one config at a time through ``paper.common.train_gluadfl``.

    python -m repro_torch.paper.fig5_async [--device cpu] [--full] [--serial]
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.config import FLConfig, SweepConfig
from repro_torch.core import GluADFL, SweepGrid
from repro_torch.models import LSTMModel
from repro_torch.optim import adam
from repro_torch.paper.common import (
    DATASETS,
    Scale,
    eval_population,
    load,
    save_json,
    scale_of,
    scale_parser,
    train_gluadfl,
)
from repro_torch.utils.pytree import tree_index

# the canonical Fig-5 grid lives in config.SweepConfig
RATIOS = list(SweepConfig().inactive_ratios)
TOPOLOGIES = list(SweepConfig().topologies)


def _run_sweep(ds: str, scale: Scale, ratios) -> dict:
    """One train_sweep call per dataset over G = topologies x ratios x
    seeds scenarios; each scenario's test-split clinical metrics, then
    the mean over seeds."""
    fed = load(ds, scale)
    model = LSTMModel(hidden=scale.hidden).as_model()
    seeds = list(range(scale.seeds))
    grid = SweepGrid.build(TOPOLOGIES, ratios, seeds, num_nodes=fed.num_nodes)
    cfg = FLConfig(topology=TOPOLOGIES[0], num_nodes=fed.num_nodes,
                   comm_batch=7, rounds=scale.rounds)
    tr = GluADFL(model, adam(2e-3), cfg, device=scale.torch_device)
    pops, _, _ = tr.train_sweep(fed.x, fed.y, fed.counts, grid=grid,
                                batch_size=scale.batch_size)
    rmse_by = {}
    for g, (topo, ratio, _) in enumerate(grid.labels):
        m = eval_population(model, tree_index(pops, g), fed)
        rmse_by.setdefault((topo, ratio), []).append(m["rmse"])
    return {
        topo: [(r, float(np.mean(rmse_by[(topo, r)]))) for r in ratios]
        for topo in TOPOLOGIES
    }


def _run_serial(ds: str, scale: Scale, ratios) -> dict:
    """The same grid one config at a time, over the same seeds, so the
    two paths stay comparable."""
    out = {}
    for topo in TOPOLOGIES:
        curve = []
        for r in ratios:
            vals = []
            for seed in range(scale.seeds):
                model, pop, _, fed = train_gluadfl(
                    ds, scale, topology=topo, inactive_ratio=r, seed=seed
                )
                vals.append(eval_population(model, pop, fed)["rmse"])
            curve.append((r, float(np.mean(vals))))
        out[topo] = curve
    return out


def run(scale: Scale | None = None, datasets=None, ratios=None,
        serial: bool = False) -> dict:
    scale = scale or Scale()
    datasets = datasets or DATASETS
    ratios = ratios or RATIOS
    out = {}
    for ds in datasets:
        out[ds] = (_run_serial if serial else _run_sweep)(ds, scale, ratios)
        for topo in TOPOLOGIES:
            print(f"[{ds:11s}] {topo:8s} " +
                  "  ".join(f"{r:.0%}:{v:.2f}" for r, v in out[ds][topo]))
        # the stability check at 70% inactive
        for topo in TOPOLOGIES:
            base = out[ds][topo][0][1]
            at70 = dict(out[ds][topo]).get(0.7, base)
            print(f"[{ds:11s}] {topo:8s} RMSE at 70% inactive vs active: "
                  f"{at70 - base:+.2f} mg/dL")
    save_json("fig5_async", out)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = scale_parser(__doc__.splitlines()[0])
    ap.add_argument("--serial", action="store_true",
                    help="one config at a time through train() instead of the batched "
                         "train_sweep path")
    args = ap.parse_args(argv)
    run(scale_of(args), serial=args.serial)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
