"""The benchmark's side of the system under test: the port's trainer
(``repro_torch.core.GluADFL``) built from a cell's files, and the
streaming eval the traffic asks for.  The drivers call the program only
through its public API; this module is the one place that knows how a
configuration and a traffic file become the trainer's arguments."""
from __future__ import annotations

import torch


def build_trainer(cell, num_nodes: int, device, *, topology: str, inactive_ratio: float):
    """``GluADFL`` with the configuration's LSTM and federation and the
    traffic's optimizer, mixer and gossip representation."""
    from repro_torch.config import FLConfig
    from repro_torch.core import GluADFL
    from repro_torch.models import LSTMModel
    from repro_torch.optim import adam

    model, fed, traffic = cell.config["model"], cell.config["federation"], cell.traffic
    opt = traffic["optimizer"]
    if opt["name"] != "adam":
        raise ValueError(f"the reference follows Adam alone, not {opt['name']!r}")
    lstm = LSTMModel(history_len=model["history_len"], hidden=model["hidden"],
                     input_size=model["input_size"])
    cfg = FLConfig(topology=topology, num_nodes=num_nodes, comm_batch=fed["comm_batch"],
                   local_steps=traffic["local_steps"], inactive_ratio=inactive_ratio,
                   cluster_size=fed["cluster_size"])
    return GluADFL(lstm.as_model(), adam(opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"]),
                   cfg, mixer=traffic["mixer"], gossip_repr=traffic["gossip_repr"],
                   device=device)


def eval_args(trainer, twin, spec: dict):
    """``(eval_fn, val_data)`` of the traffic's eval: its window set
    (``"launcher"`` or ``"pooled"``, see ``Twin.val_set``) and its units:
    ``"normalised"`` is the trainer's built-in val RMSE, ``"mgdl"`` the
    RMSE in mg/dL as an ``eval_fn``, as ``paper/fig4_topology.py`` runs
    it."""
    vx, vy = twin.val_set(spec["set"])
    if spec["units"] == "normalised":
        return None, (vx, vy)
    if spec["units"] != "mgdl":
        raise ValueError(f"unknown eval units {spec['units']!r}")
    model, mean, sd = trainer.model, twin.mean, twin.sd

    def val_rmse(params, val_x, val_y):
        with torch.no_grad():
            pred = model.apply(params, val_x) * sd + mean
            return {"val_rmse": torch.sqrt(torch.mean(torch.square(pred - val_y)))}

    return val_rmse, (vx, vy * sd + mean)
