"""Table 4: BG prediction for seen/unseen patients by ALL population
methods: LR, XGBoost-like GBT, LSTM (supervised), N-BEATS, N-HiTS, MAML,
MetaSGD, FedAvg, GluADFL(Ring/Cluster/Random).  The counterpart of
``benchmarks/table4_baselines.py``.

The trainable baselines (FedAvg, MAML, MetaSGD, LSTM-supervised) run on
the chunk engine (``core.chunked``): :func:`run_baseline_grid` trains the
method grid with ``chunk = rounds``, one chunk per method and <= 4 in
all, counted through ``chunked.dispatch_chunk``.  Every LSTM population
is evaluated through ``LSTMModel.apply`` (``paper.common.eval_population``;
on CUDA the ``lstm_forward`` kernel).

    python -m repro_torch.paper.table4_baselines [--device cpu] [--full]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.config import FLConfig
from repro_torch.core import MAML, FedAvg, MetaSGD, train_supervised
from repro_torch.data.pipeline import FederatedData
from repro_torch.metrics import all_metrics
from repro_torch.models import (
    GradientBoostedTrees,
    LinearModel,
    LSTMModel,
    NBeatsModel,
    NHiTSModel,
)
from repro_torch.models.linear import fit_closed_form
from repro_torch.optim import adam
from repro_torch.paper.common import (
    DATASETS,
    Scale,
    eval_population,
    load,
    main,
    pooled,
    save_json,
    train_fedavg,
    train_gluadfl,
    train_mixed_supervised,
)


def _eval_gbt(gbt, params, fed: FederatedData, device) -> dict:
    preds, ys = [], []
    for p in fed.patients:
        if len(p.test_x) == 0:
            continue
        pred = gbt.predict(params, torch.as_tensor(p.test_x, device=device))
        preds.append(pred.cpu().numpy() * fed.sd + fed.mean)
        ys.append(p.test_y_raw)
    return all_metrics(np.concatenate(ys), np.concatenate(preds))


def _train_eval_method(method: str, train_ds: str, scale: Scale):
    """Returns eval-fn(test_fed) -> metrics."""
    fed = load(train_ds, scale)
    dev = scale.torch_device
    x, y = pooled(fed, "train")

    if method == "lr":
        params = fit_closed_form(torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev))
        model = LinearModel(history_len=12).as_model()
        return lambda te: eval_population(model, params, te)
    if method == "xgboost":
        gbt = GradientBoostedTrees(num_trees=40, depth=4, lr=0.15)
        params = gbt.fit(x, y)
        return lambda te: _eval_gbt(gbt, params, te, dev)
    if method in ("lstm", "nbeats", "nhits"):
        ctor = {
            "lstm": lambda: LSTMModel(hidden=scale.hidden).as_model(),
            "nbeats": lambda: NBeatsModel(hidden=scale.hidden).as_model(),
            "nhits": lambda: NHiTSModel(hidden=scale.hidden).as_model(),
        }[method]
        model, params, _, _ = train_mixed_supervised(train_ds, scale, model_ctor=ctor)
        return lambda te: eval_population(model, params, te)
    if method in ("maml", "metasgd"):
        model = LSTMModel(hidden=scale.hidden).as_model()
        cls = MAML if method == "maml" else MetaSGD
        meta = cls(model, adam(1e-3), inner_lr=1e-2, inner_steps=3, device=dev)
        params, _, _ = meta.train(scale.generator(0), fed.x, fed.y, fed.counts,
                                  batch_size=scale.batch_size, steps=scale.rounds)
        # the paper: evaluated WITHOUT test-time fine-tuning
        return lambda te: eval_population(model, params, te)
    if method == "fedavg":
        model, params, _, _ = train_fedavg(train_ds, scale)
        return lambda te: eval_population(model, params, te)
    if method.startswith("gluadfl"):
        topo = method.split("-")[1]
        model, pop, _, _ = train_gluadfl(train_ds, scale, topology=topo)
        return lambda te: eval_population(model, pop, te)
    raise KeyError(method)


METHODS = [
    "lr", "xgboost", "lstm", "nbeats", "nhits", "maml", "metasgd",
    "fedavg", "gluadfl-ring", "gluadfl-cluster", "gluadfl-random",
]

# The four baselines on the chunk engine.
BASELINE_GRID_METHODS = ("fedavg", "maml", "metasgd", "lstm")


def run_baseline_grid(train_ds: str, scale: Scale | None = None,
                      methods=BASELINE_GRID_METHODS, *, engine: str = "scan",
                      seed: int = 0) -> dict:
    """Train the Table-4 trainable-baseline grid on one dataset.

    With ``engine="scan"`` each method runs its whole round budget as a
    single chunk (``chunk = rounds``), so the grid dispatches <=
    len(methods) <= 4 chunks through ``chunked.dispatch_chunk``;
    ``engine="loop"`` syncs every round.

    Returns ``{method: {"model", "params", "history"}}``.
    """
    scale = scale or Scale()
    fed = load(train_ds, scale)
    dev = scale.torch_device
    out: dict = {}
    for method in methods:
        model = LSTMModel(hidden=scale.hidden).as_model()
        if method == "fedavg":
            cfg = FLConfig(num_nodes=fed.num_nodes, rounds=scale.rounds,
                           local_steps=2, seed=seed)
            fa = FedAvg(model, adam(2e-3), cfg, device=dev)
            params, hist = fa.train(
                scale.generator(seed), fed.x, fed.y, fed.counts,
                batch_size=scale.batch_size, engine=engine, chunk=scale.rounds,
            )
        elif method in ("maml", "metasgd"):
            cls = MAML if method == "maml" else MetaSGD
            meta = cls(model, adam(1e-3), inner_lr=1e-2, inner_steps=3, device=dev)
            params, _, hist = meta.train(
                scale.generator(seed), fed.x, fed.y, fed.counts,
                batch_size=scale.batch_size, steps=scale.rounds,
                engine=engine, chunk=scale.rounds,
            )
        elif method == "lstm":
            x, y = pooled(fed, "train")
            params, hist = train_supervised(
                model, adam(2e-3), scale.generator(seed), x, y,
                steps=scale.rounds, batch_size=scale.batch_size,
                engine=engine, chunk=scale.rounds, device=dev,
            )
        else:
            raise KeyError(method)
        out[method] = {"model": model, "params": params, "history": hist}
    return out


def run(scale: Scale | None = None, datasets=None, methods=None) -> dict:
    scale = scale or Scale()
    datasets = datasets or DATASETS
    methods = methods or METHODS
    out: dict = {}
    for train_ds in datasets:
        out[train_ds] = {}
        for method in methods:
            ev = _train_eval_method(method, train_ds, scale)
            seen = ev(load(train_ds, scale))
            unseen = [ev(load(d, scale)) for d in datasets if d != train_ds]
            unseen_mean = {
                k: float(np.mean([u[k] for u in unseen])) for k in seen
            } if unseen else {}
            out[train_ds][method] = {"seen": seen, "unseen": unseen_mean}
            print(
                f"[{train_ds:11s}] {method:16s} seen RMSE {seen['rmse']:6.2f} "
                f"gRMSE {seen['grmse']:6.2f} | unseen RMSE "
                f"{unseen_mean.get('rmse', float('nan')):6.2f}"
            )
    save_json("table4_baselines", out)
    return out


if __name__ == "__main__":
    sys.exit(main(run, sys.argv[1:], __doc__.splitlines()[0]))
