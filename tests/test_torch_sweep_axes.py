"""The sweep's optional scenario axes against the JAX package's: the
Markov-sticky schedule, the non-IID data skew and the DP sigma, each
armed alone and all three together, through the port's ``train_sweep``
and ``repro.core.GluADFL.train_sweep`` from the same initial params and
per-scenario draws (the helpers and tolerances of
``tests/test_torch_sweep.py``), and one axis-armed scenario against the
port's serial ``train()`` of its config.
"""
import pytest
import torch

from repro_torch.config import FLConfig
from repro_torch.core import GluADFL, SweepGrid
from repro_torch.models import LSTMModel
from repro_torch.optim import get_optimizer
from test_torch_sweep import (BATCH, COMM_BATCH, N, assert_sweeps_agree, grids, run_both,
                              toy_fed)

AXES = {
    "markov": dict(schedules=("bernoulli", "markov")),
    "skew": dict(skews=(0.0, 0.5)),
    "dp": dict(dp_sigmas=(0.0, 0.05)),
    "all": dict(schedules=("bernoulli", "markov"), skews=(0.0, 0.5), dp_sigmas=(0.01, 0.05)),
}


@pytest.mark.parametrize("axis", list(AXES))
def test_axis_matches_jax(axis):
    """(ring, random) x 0.4 x seed 0 under each armed axis: losses, val
    RMSE, params, population and staleness against JAX's sweep."""
    topologies = ("ring", "random") if axis != "all" else ("random",)
    jgrid, grid = grids(topologies, (0.4,), (0,), **AXES[axis])
    assert len(grid.labels[0]) == 6
    jout, tout = run_both(jgrid, grid, opt="sgd")
    assert_sweeps_agree(jout, tout, "sgd", grid.size)


def test_all_axes_scenario_equals_its_serial_twin():
    """A scenario that engages all three axes (markov, skew 0.5, sigma
    0.05) against the port's serial run of its config, the skew through
    ``FLConfig(data_skew=...)``: bitwise on the CPU."""
    x, y, counts = toy_fed(seed=3)
    grid = SweepGrid.build(("cluster",), (0.3,), (4,), num_nodes=N,
                           schedules=("markov",), skews=(0.5,), dp_sigmas=(0.05,))
    sweep = GluADFL(LSTMModel(hidden=8).as_model(), get_optimizer("sgd", 1e-2),
                    FLConfig(num_nodes=N, comm_batch=COMM_BATCH), device="cpu")
    _, hists, states = sweep.train_sweep(x, y, counts, grid=grid, batch_size=BATCH, rounds=5)
    cfg = FLConfig(topology="cluster", num_nodes=N, comm_batch=COMM_BATCH, inactive_ratio=0.3,
                   schedule="markov", data_skew=0.5)
    serial = GluADFL(LSTMModel(hidden=8).as_model(), get_optimizer("sgd", 1e-2), cfg,
                     dp_noise_sigma=0.05, device="cpu")
    _, hist, state = serial.train(torch.Generator().manual_seed(4), x, y, counts,
                                  batch_size=BATCH, rounds=5)
    assert hists[0] == hist
    assert torch.equal(states.params[0], state.params)
    assert torch.equal(states.staleness[0], state.staleness)
