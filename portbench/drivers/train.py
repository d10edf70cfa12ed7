"""The ``train`` driver: one federation through ``GluADFL.train``, each
call one chunk of the engine, continued through ``state=``, the rounds'
draws handed in through ``draws=``."""
from __future__ import annotations

import numpy as np

from portbench.generator import scenarios
from portbench.program import build_trainer, eval_args


class Driver:
    def __init__(self, cell, twin, device):
        traffic = cell.traffic
        (scenario,) = scenarios(traffic)
        self.n, self.g = twin.num_nodes, 1
        self.trainer = build_trainer(cell, self.n, device, topology=scenario.topology,
                                     inactive_ratio=scenario.inactive_ratio)
        self.data = (twin.x, twin.y, twin.counts)
        self.batch, self.chunk = traffic["batch_size"], traffic["chunk"]
        self.eval_fn, self.val_data = eval_args(self.trainer, twin, traffic["eval"])
        model = cell.config["model"]
        self.eval_launches = [(1, len(self.val_data[0]), model["history_len"],
                               model["input_size"], model["hidden"])]

    def start(self, leaves: dict):
        return self.trainer.state_from_params(leaves)

    def call(self, state, draws, rounds: int, eval_every: int):
        """One ``train`` call of ``rounds`` rounds: the new state, the
        losses (1, rounds), the eval records {round index: (1,)} and the
        population (leaves (1, ...))."""
        from repro_torch.utils.rng import RoundDraws

        def one():
            u, scores, idx = draws.next()
            return RoundDraws(u[0], None if scores is None else scores[0], idx[0])

        stream = (one() for _ in range(rounds))
        x, y, counts = self.data
        pop, hist, state = self.trainer.train(
            None, x, y, counts, batch_size=self.batch, rounds=rounds,
            chunk=min(self.chunk, rounds), eval_every=eval_every, eval_fn=self.eval_fn,
            val_data=self.val_data, state=state, draws=stream)
        evals = {i: np.array([h["val_rmse"]]) for i, h in enumerate(hist) if "val_rmse" in h}
        return state, np.array([[h["loss"] for h in hist]]), evals, \
            {k: v[None] for k, v in pop.items()}

    def flat(self, t):
        return t.reshape(self.n, -1)
