"""Figure 4: convergence of GluADFL under ring / cluster / random
topologies (B=7), per dataset -- validation RMSE in mg/dL against the
communication round.  The counterpart of ``benchmarks/fig4_topology.py``.

Default path: the whole topology grid (G=3) trains as one batched
federation through ``GluADFL.train_sweep``, with the mg/dL val RMSE as
its streaming ``eval_fn``: each eval round calls it once a scenario, so
on CUDA it is 3 ``lstm_forward`` launches over the pooled val windows.
``--serial`` (or ``run(serial=True)``) trains the three configs one at
a time through ``GluADFL.train``, the same numbers.

    python -m repro_torch.paper.fig4_topology [--device cpu] [--full] [--serial]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.config import FLConfig, SweepConfig
from repro_torch.core import GluADFL, SweepGrid
from repro_torch.models import LSTMModel
from repro_torch.optim import adam
from repro_torch.paper.common import DATASETS, Scale, load, save_json, scale_of, scale_parser

# Fig 4 sweeps the same canonical topology axis as Fig 5
TOPOLOGIES = list(SweepConfig().topologies)


def _val_rmse_fn(model, fed):
    """The population's val RMSE in mg/dL, as ``eval_fn``: one forward
    of the pooled val windows, the value left on the device until the
    chunk's host sync."""

    def val_rmse(params, val_x, val_y):
        with torch.no_grad():
            pred = model.apply(params, val_x) * fed.sd + fed.mean
            return {"val_rmse": torch.sqrt(torch.mean(torch.square(pred - val_y)))}

    return val_rmse


def run(scale: Scale | None = None, datasets=None, eval_every: int = 10,
        serial: bool = False) -> dict:
    scale = scale or Scale()
    datasets = datasets or DATASETS
    out = {}
    for ds in datasets:
        fed = load(ds, scale)
        model = LSTMModel(hidden=scale.hidden).as_model()
        vx = np.concatenate([p.val_x for p in fed.patients])
        vy_raw = np.concatenate([(p.val_y * fed.sd + fed.mean) for p in fed.patients])
        val_rmse = _val_rmse_fn(model, fed)

        out[ds] = {}
        if serial:
            for topo in TOPOLOGIES:
                cfg = FLConfig(topology=topo, num_nodes=fed.num_nodes,
                               comm_batch=7, rounds=scale.rounds)
                tr = GluADFL(model, adam(2e-3), cfg, device=scale.torch_device)
                _, hist, _ = tr.train(
                    scale.generator(0), fed.x, fed.y, fed.counts,
                    batch_size=scale.batch_size, eval_every=eval_every,
                    eval_fn=val_rmse, val_data=(vx, vy_raw),
                )
                out[ds][topo] = [(h["round"], h["val_rmse"])
                                 for h in hist if "val_rmse" in h]
        else:
            # the whole topology axis as one batched federation: each
            # scenario's (round, val_rmse) curve from the streaming eval
            grid = SweepGrid.build(TOPOLOGIES, [0.0], [0], num_nodes=fed.num_nodes)
            cfg = FLConfig(topology=TOPOLOGIES[0], num_nodes=fed.num_nodes,
                           comm_batch=7, rounds=scale.rounds)
            tr = GluADFL(model, adam(2e-3), cfg, device=scale.torch_device)
            _, hists, _ = tr.train_sweep(
                fed.x, fed.y, fed.counts, grid=grid,
                batch_size=scale.batch_size, eval_every=eval_every,
                eval_fn=val_rmse, val_data=(vx, vy_raw),
            )
            for (topo, _, _), hist in zip(grid.labels, hists):
                out[ds][topo] = [(h["round"], h["val_rmse"])
                                 for h in hist if "val_rmse" in h]

        for topo in TOPOLOGIES:
            print(f"[{ds:11s}] {topo:8s} final val RMSE "
                  f"{out[ds][topo][-1][1]:.2f}")
        finals = {t: out[ds][t][-1][1] for t in TOPOLOGIES}
        order = sorted(finals, key=finals.get)
        print(f"[{ds:11s}] convergence order: {' < '.join(order)} "
              "(paper: random < cluster < ring)")
    save_json("fig4_topology", out)
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
