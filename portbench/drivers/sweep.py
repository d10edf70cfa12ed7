"""The ``sweep`` driver: the traffic's grid of scenarios trained as one
batched federation through ``GluADFL.train_sweep``, each call one chunk
of the engine, continued through ``states=``, the rounds' draws handed
in through ``draws=``."""
from __future__ import annotations

import numpy as np

from portbench.generator import scenarios
from portbench.program import build_trainer, eval_args


class Driver:
    def __init__(self, cell, twin, device):
        from repro_torch.core import SweepGrid

        traffic = cell.traffic
        self.n = twin.num_nodes
        self.trainer = build_trainer(cell, self.n, device, topology=traffic["topologies"][0],
                                     inactive_ratio=0.0)
        reps = int(traffic.get("seeds_per_scenario", 1))
        self.grid = SweepGrid.build(traffic["topologies"], traffic["inactive_ratios"],
                                    range(reps), num_nodes=self.n,
                                    cluster_size=cell.config["federation"]["cluster_size"])
        mine = [(s.topology, s.inactive_ratio) for s in scenarios(traffic)]
        if [(t, r) for t, r, _ in self.grid.labels] != mine:
            raise ValueError(f"the engine's grid {self.grid.labels} is not the traffic's {mine}")
        self.g = self.grid.size
        self.data = (twin.x, twin.y, twin.counts)
        self.batch, self.chunk = traffic["batch_size"], traffic["chunk"]
        self.eval_fn, self.val_data = eval_args(self.trainer, twin, traffic["eval"])
        model = cell.config["model"]
        r = len(self.val_data[0])
        shape = (model["history_len"], model["input_size"], model["hidden"])
        # the built-in eval is one launch of G groups, a caller's eval_fn one a scenario
        self.eval_launches = [(self.g, r, *shape)] if self.eval_fn is None else \
            [(1, r, *shape)] * self.g

    def start(self, leaves: dict):
        """The state of G·N rows of params, row g·N + n node n of scenario g."""
        return self.trainer.state_from_params(
            {k: v.reshape(self.g, self.n, *v.shape[1:]) for k, v in leaves.items()})

    def call(self, state, draws, rounds: int, eval_every: int):
        """One ``train_sweep`` call of ``rounds`` rounds: the new state,
        the losses (G, rounds), the eval records {round index: (G,)} and
        the populations (leaves (G, ...))."""
        from repro_torch.utils.rng import RoundDraws

        stream = (RoundDraws(*draws.next()) for _ in range(rounds))
        x, y, counts = self.data
        pops, hists, state = self.trainer.train_sweep(
            x, y, counts, grid=self.grid, batch_size=self.batch, rounds=rounds,
            chunk=min(self.chunk, rounds), eval_every=eval_every, eval_fn=self.eval_fn,
            val_data=self.val_data, states=state, draws=stream)
        losses = np.array([[h["loss"] for h in hist] for hist in hists])
        evals = {i: np.array([hist[i]["val_rmse"] for hist in hists])
                 for i in range(rounds) if "val_rmse" in hists[0][i]}
        return state, losses, evals, pops

    def flat(self, t):
        """A state tensor as its (G·N, D) rows."""
        return t.reshape(self.g * self.n, -1)
