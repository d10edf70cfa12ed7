"""The plain reference against the port's CPU path at a tiny size: each
layer the comparison covers alone, then three whole rounds of both tiny
cells (G=3 scenarios, and one federation on the kernel mixer's CPU
twins), N=8, H=16."""
import numpy as np
import pytest
import torch

from portbench_tiny import TINY, tiny_bench

from portbench import check, generator, harness, reference, spec


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setattr(harness, "HOST_THREADS", 1)
    torch.set_num_threads(1)


def test_layers_match_the_port():
    from repro_torch.core.async_sched import bernoulli_active
    from repro_torch.core.topology import (mixing_matrix, random_adjacency,
                                           static_adjacency)
    from repro_torch.models import LSTMModel

    gen = torch.Generator().manual_seed(5)
    n, b = 12, 3
    u = torch.rand((3, n), generator=gen)
    ratios = torch.tensor([0.0, 0.5, 0.99])
    act = generator.active_mask(u, ratios)
    assert torch.equal(act, bernoulli_active(u, ratios))
    scores = torch.rand((3, n, n), generator=gen)
    assert torch.equal(reference.random_graph(scores, b), random_adjacency(scores, b))
    for topo in ("ring", "cluster"):
        assert np.array_equal(reference.static_graph(topo, n, 4),
                              static_adjacency(topo, n, 4).numpy())
    adj = reference.random_graph(scores, b)
    assert torch.equal(reference.mixing(adj, act, b), mixing_matrix(adj, act, b))
    lstm = LSTMModel(hidden=16)
    p = {k: torch.stack([lstm.init(gen)[k] for _ in range(n)]) for k in generator.LEAVES}
    x = torch.randn((n, 5, 12), generator=gen)
    torch.testing.assert_close(reference.lstm(p, x), lstm.apply_nodes(p, x), rtol=0, atol=1e-6)


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10 + 2 ** -12)])
    assert reference.to_tf32(t).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]


@pytest.mark.parametrize("cell", sorted(TINY))
def test_rounds_match_the_port(tmp_path, cell):
    root, bench = tiny_bench(tmp_path)
    c = spec.load_cell(cell, root, bench)
    harness.configure(c)
    data, drv, grid = harness.start(c, "cpu", [])
    _, _, prog = harness.checked_rounds(c, drv, data, grid, 2 ** 33 + 7, "cpu")
    ref = harness.reference_readings(c, data, grid, 2 ** 33 + 7, "cpu")
    assert prog.loss.shape == ref.loss.shape == (drv.g, harness.CHECKED_ROUNDS)
    numbers = check.gaps(prog, ref)
    assert max(numbers.values()) < 1e-6, numbers
