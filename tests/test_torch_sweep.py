"""The port's scenario-sweep engine against the JAX package's.

The stacked topology builders, the batched activity masks and
``SweepGrid.build`` against ``repro``'s (bitwise); ``train_sweep``
against ``repro.core.GluADFL.train_sweep`` from the same initial params
and, per scenario, the draws ``_round`` makes from that scenario's key
chain (split here in ``_round``'s order, as ``tests/test_torch_train.py``
does for one run, and handed in stacked); a port sweep against the
port's serial ``train()`` from the same seeded generators; masked
sweeps against unmasked ones; the G-group eval against per-scenario
applies; the CLI's sweep summary and refusals.  The optional axes are
held against JAX in ``tests/test_torch_sweep_axes.py``.

Tolerances against JAX, those ``tests/test_torch_train.py`` states for
a few rounds of training (fp32 summation order of the gradient and of
the gossip contraction, compounded over rounds): with SGD, params and
populations within ``atol=1e-5``, losses and val RMSE within
``atol=2e-6``; with Adam, losses within ``atol=1e-4`` and params within
a relative norm of ``1e-3``; staleness, the optimizer's int32 ``step``
and the round counters bitwise.  Against the port's own serial runs on
the CPU the sweep is bitwise at these shapes: the same draws, and every
stacked operation computes each scenario's rows as the unstacked one
does (the serial test says where that can fail at larger N).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JaxFLConfig
from repro.config import SweepConfig as JaxSweepConfig
from repro.core import GluADFL as JaxGluADFL
from repro.core import SweepGrid as JaxSweepGrid
from repro.core import async_sched as jax_sched
from repro.core import topology as jax_topo
from repro.metrics import all_metrics as jax_all_metrics
from repro.models import LSTMModel as JaxLSTM
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.config import FLConfig, SweepConfig
from repro_torch.core import GluADFL, SweepGrid, async_sched, topology
from repro_torch.kernels import ref
from repro_torch.launch import train as train_cli
from repro_torch.models import LSTMModel
from repro_torch.optim import get_optimizer
from repro_torch.utils.pytree import tree_index
from repro_torch.utils.rng import RoundDraws

N = 6
H = 8
BATCH = 8
COMM_BATCH = 3
LR = {"sgd": 1e-2, "adam": 1e-3}
ROUNDS, CHUNK, EVAL_EVERY = 6, 4, 2  # a chunk remainder, evals in both chunks


def toy_fed(n=N, m=40, steps=12, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m, steps)).astype(np.float32)
    y = (x @ rng.normal(size=(steps,)).astype(np.float32)
         + 0.01 * rng.normal(size=(n, m))).astype(np.float32)
    counts = rng.integers(m // 2, m + 1, size=n).astype(np.int32)
    return x, y, counts


def val_set(m=24, steps=12, seed=7):
    rng = np.random.default_rng(seed)
    vx = rng.normal(size=(m, steps)).astype(np.float32)
    return vx, (vx @ rng.normal(size=(steps,)).astype(np.float32)).astype(np.float32)


def flat(tree, lead):
    """Leaves (*lead, ...) in sorted-key order -> (*lead, D) numpy."""
    return np.concatenate([np.asarray(tree[k]).reshape(*lead, -1) for k in sorted(tree)], axis=-1)


@functools.partial(jax.jit, static_argnums=(2,))
def _batch_idx(k_batch, counts, batch):
    """``_round``'s (N, 1, batch) indices: ``split(k_batch, N)``, then
    ``split(node_key, 1)``, then ``randint(.., 0, max(count, 1))``."""
    def node(node_key, c):
        return jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, jnp.maximum(c, 1)))(
            jax.random.split(node_key, 1))
    return jax.vmap(node)(jax.random.split(k_batch, counts.shape[0]), counts)


def jax_round_draws(key, counts, *, dp_like=None):
    """One round's draws from one scenario's key in ``_round``'s split
    order: ``(next_key, u, scores, batch_idx, noise)`` as numpy."""
    n = counts.shape[0]
    key, k_act, k_top, k_batch = jax.random.split(key, 4)
    noise = None
    if dp_like is not None:
        key, k_dp = jax.random.split(key)
        leaves = [dp_like[k] for k in sorted(dp_like)]
        keys = jax.random.split(k_dp, len(leaves))
        noise = np.concatenate([np.asarray(jax.random.normal(k, l.shape, l.dtype)).reshape(n, -1)
                                for k, l in zip(keys, leaves)], axis=1)
    return (key, np.asarray(jax.random.uniform(k_act, (n,))),
            np.asarray(jax.random.uniform(k_top, (n, n))),
            np.asarray(_batch_idx(k_batch, jnp.asarray(counts), BATCH)).astype(np.int64), noise)


def jax_sweep_draws(keys, grid, counts, rounds, *, dp_like=None):
    """The stacked :class:`RoundDraws` of ``rounds`` swept rounds: row g
    from scenario g's key chain (``keys[g]``, its state key after
    init); scores only for the resampled scenarios, as the port draws."""
    keys = list(keys)
    resample = np.asarray(grid.resample) > 0
    for _ in range(rounds):
        rows = []
        for g, key in enumerate(keys):
            keys[g], *draw = jax_round_draws(key, counts, dp_like=dp_like)
            rows.append(draw)
        u, scores, idx, noise = (np.stack(col) if col[0] is not None else None
                                 for col in zip(*rows))
        scores = np.where(resample[:, None, None], scores, 0.0).astype(np.float32)
        yield RoundDraws(torch.from_numpy(u), torch.from_numpy(scores) if resample.any() else None,
                         torch.from_numpy(idx),
                         None if noise is None else torch.from_numpy(noise))


def grids(topologies, ratios, seeds, **axes):
    return (JaxSweepGrid.build(topologies, ratios, seeds, num_nodes=N, **axes),
            SweepGrid.build(topologies, ratios, seeds, num_nodes=N, **axes))


def run_both(jgrid, grid, *, opt="sgd", sigma=0.0, gossip_repr="dense", fl=None):
    """The JAX sweep and the port's on the same data, initial params and
    draws; returns both runs' ``(pops, histories, states)``."""
    x, y, counts = toy_fed()
    val = val_set()
    cfg = dict(num_nodes=N, comm_batch=COMM_BATCH, **(fl or {}))
    jt = JaxGluADFL(JaxLSTM(hidden=H).as_model(), jax_get_optimizer(opt, LR[opt]),
                    JaxFLConfig(**cfg), dp_noise_sigma=sigma, gossip_repr=gossip_repr)
    tt = GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer(opt, LR[opt]), FLConfig(**cfg),
                 dp_noise_sigma=sigma, gossip_repr=gossip_repr, device="cpu")
    jout = jt.train_sweep(x, y, counts, grid=jgrid, batch_size=BATCH, rounds=ROUNDS, chunk=CHUNK,
                          eval_every=EVAL_EVERY, val_data=val)
    init = jt._sweep_init_jit(jgrid.init_keys)
    states = tt.state_from_params({k: np.asarray(v) for k, v in init.params.items()})
    armed = sigma > 0 or jgrid.dp_sigma is not None
    one = {k: v[0] for k, v in init.params.items()}
    draws = jax_sweep_draws(init.key, jgrid, counts, ROUNDS, dp_like=one if armed else None)
    tout = tt.train_sweep(x, y, counts, grid=grid, batch_size=BATCH, rounds=ROUNDS, chunk=CHUNK,
                          eval_every=EVAL_EVERY, val_data=val, states=states, draws=draws)
    return jout, tout


def assert_sweeps_agree(jout, tout, opt, g_count):
    (jpops, jhists, jstates), (pops, hists, states) = jout, tout
    assert len(hists) == g_count and states.params.shape[:2] == (g_count, N)
    got, want = states.params.numpy(), flat(jstates.params, (g_count, N))
    for g in range(g_count):
        assert [sorted(h) for h in hists[g]] == [sorted(h) for h in jhists[g]]
        assert [h["round"] for h in hists[g]] == list(range(ROUNDS))
        losses = [h["loss"] for h in hists[g]]
        jlosses = [h["loss"] for h in jhists[g]]
        vals = [h["val_rmse"] for h in hists[g] if "val_rmse" in h]
        jvals = [h["val_rmse"] for h in jhists[g] if "val_rmse" in h]
        assert len(vals) == ROUNDS // EVAL_EVERY
        if opt == "sgd":
            np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-6)
            np.testing.assert_allclose(vals, jvals, rtol=0, atol=2e-6)
            np.testing.assert_allclose(got[g], want[g], rtol=0, atol=1e-5)
            np.testing.assert_allclose(flat({k: v[None] for k, v in tree_index(pops, g).items()}, (1,)),
                                       flat({k: np.asarray(v)[g][None] for k, v in jpops.items()},
                                            (1,)), rtol=0, atol=1e-5)
        else:
            np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
            assert np.linalg.norm(got[g] - want[g]) <= 1e-3 * np.linalg.norm(want[g])
    np.testing.assert_array_equal(states.staleness.numpy(), np.asarray(jstates.staleness))
    np.testing.assert_array_equal(states.opt_state["step"].numpy(),
                                  np.asarray(jstates.opt_state["step"]))
    assert states.round == ROUNDS and (np.asarray(jstates.round) == ROUNDS).all()


# ------------------------------------------------------- batched builders


def test_stacked_topology_helpers_match_jax():
    n, g = 9, 4
    adj, resample = topology.stacked_adjacency(["ring", "cluster", "random", "star"], n)
    jadj, jres = jax_topo.stacked_adjacency(["ring", "cluster", "random", "star"], n)
    np.testing.assert_array_equal(adj.numpy(), np.asarray(jadj))
    np.testing.assert_array_equal(resample.numpy(), np.asarray(jres))
    with pytest.raises(KeyError):
        topology.stacked_adjacency(["ring", "moebius"], n)
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.PRNGKey(1), g)
    scores = np.stack([np.asarray(jax.random.uniform(k, (n, n))) for k in keys])
    drawn = topology.random_adjacency(torch.from_numpy(scores), 3)
    for s in range(g):
        np.testing.assert_array_equal(drawn[s].numpy(),
                                      np.asarray(jax_topo.random_adjacency(keys[s], n, 3)))
    adj = torch.where(resample[:, None, None] > 0, drawn, adj)
    active = (rng.uniform(size=(g, n)) > 0.3).astype(np.float32)
    for b in (0, 2, 7):
        mix = topology.mixing_matrix_stacked(adj, torch.from_numpy(active), b)
        np.testing.assert_array_equal(
            mix.numpy(), np.asarray(jax_topo.mixing_matrix_stacked(jnp.asarray(adj.numpy()),
                                                                   jnp.asarray(active), b)))
        idx, wgt = topology.stacked_neighbor_table(adj, torch.from_numpy(active), b)
        jidx, jwgt = jax_topo.stacked_neighbor_table(jnp.asarray(adj.numpy()),
                                                     jnp.asarray(active), b)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(wgt.numpy(), np.asarray(jwgt))
        for s in range(g):
            np.testing.assert_array_equal(
                topology.densify_neighbor_table(idx[s], wgt[s]).numpy(), mix[s].numpy())
            assert topology.spectral_gap(mix[s]) == jax_topo.spectral_gap(np.asarray(mix[s]))


def test_batched_activity_masks_match_jax():
    """(G, N) masks at (G,) ratios, ratio 0 and a row whose every node
    falls below its ratio (the per-row fallback) included, against the
    JAX schedules on each scenario's own uniforms."""
    n = 5
    ratios = [0.0, 0.4, 0.99, 0.7]
    key = jax.random.PRNGKey(3)
    keys = jax.random.split(key, len(ratios))
    u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in keys])
    got = async_sched.bernoulli_active(torch.from_numpy(u), torch.tensor(ratios))
    assert got.shape == (len(ratios), n)
    for g, r in enumerate(ratios):
        want = np.asarray(jax_sched.bernoulli_active(keys[g], n, jnp.float32(r)))
        np.testing.assert_array_equal(got[g].numpy(), want)
        np.testing.assert_array_equal(
            got[g].numpy(), async_sched.bernoulli_active(torch.from_numpy(u[g]), r).numpy())
    assert (u[2] < 0.99).all() and got[2].sum() == 1  # the fallback, row by row
    np.testing.assert_array_equal(got[0].numpy(), np.ones(n))  # ratio 0 = the scalar shortcut
    np.testing.assert_array_equal(
        async_sched.sweep_active_masks(torch.from_numpy(u), ratios).numpy(),
        np.asarray(jax_sched.sweep_active_masks(key, n, jnp.asarray(ratios))))
    prev = (np.arange(len(ratios) * n).reshape(len(ratios), n) % 3 == 0).astype(np.float32)
    prev[2] = 0.0
    sticky = async_sched.markov_active(torch.from_numpy(u), torch.from_numpy(prev), 0.9, 0.99)
    for g in range(len(ratios)):
        want = np.asarray(jax_sched.markov_active(keys[g], jnp.asarray(prev[g]), 0.9, 0.99))
        np.testing.assert_array_equal(sticky[g].numpy(), want)


@pytest.mark.parametrize("axes", [{}, dict(schedules=("bernoulli", "markov"), skews=(0.0, 0.5),
                                           dp_sigmas=(0.0, 0.1))], ids=["classic", "armed"])
def test_sweep_grid_build_matches_jax(axes):
    jgrid, grid = grids(("ring", "random", "cluster"), (0.0, 0.4), (0, 1), **axes)
    assert grid.labels == jgrid.labels and grid.size == jgrid.size
    assert [grid.label_dict(g) for g in range(grid.size)] == \
        [jgrid.label_dict(g) for g in range(jgrid.size)]
    for name in ("adjacency", "resample", "inactive_ratio", "markov", "skew", "dp_sigma"):
        mine, theirs = getattr(grid, name), getattr(jgrid, name)
        assert (mine is None) == (theirs is None), name
        if mine is not None:
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs), err_msg=name)
    np.testing.assert_array_equal(np.stack([np.asarray(jax.random.PRNGKey(s)) for s in grid.seeds]),
                                  np.asarray(jgrid.init_keys))
    assert grid.labels[1] == (("ring", 0.0, 1) if not axes else
                              ("ring", 0.0, "bernoulli", 0.0, 0.0, 1))


def test_sweep_grid_guards_and_the_fig5_config():
    with pytest.raises(ValueError, match="empty"):
        SweepGrid.build((), (0.0,), (0,), num_nodes=N)
    with pytest.raises(ValueError, match="unknown schedule"):
        SweepGrid.build(("ring",), (0.0,), num_nodes=N, schedules=("bernoulli", "lazy"))
    assert dataclasses.asdict(SweepConfig()) == dataclasses.asdict(JaxSweepConfig())
    cfg = SweepConfig(seeds=2)
    assert cfg.seed_list() == JaxSweepConfig(seeds=2).seed_list() == (0, 1)
    fig5 = SweepGrid.build(SweepConfig().topologies, SweepConfig().inactive_ratios,
                           SweepConfig().seed_list(), num_nodes=N)
    assert fig5.size == 15


# ------------------------------------------------------ the engine vs JAX

ENGINE_CASES = [("sgd", 0.0, "dense"), ("sgd", 0.05, "dense"), ("adam", 0.0, "dense"),
                ("sgd", 0.0, "sparse")]


@pytest.mark.parametrize("opt,sigma,gossip_repr", ENGINE_CASES,
                         ids=[f"{o}-dp{s}-{r}" for o, s, r in ENGINE_CASES])
def test_train_sweep_matches_jax(opt, sigma, gossip_repr):
    """(ring, random) x (0.0, 0.4) x seeds (0, 1), 6 rounds in chunks of
    4 with an eval every 2: every scenario's losses, val RMSE records,
    params, population and staleness against JAX's ``train_sweep``."""
    jgrid, grid = grids(("ring", "random"), (0.0, 0.4), (0, 1))
    jout, tout = run_both(jgrid, grid, opt=opt, sigma=sigma, gossip_repr=gossip_repr)
    assert_sweeps_agree(jout, tout, opt, grid.size)


def test_train_sweep_guards():
    x, y, counts = toy_fed()
    model = LSTMModel(hidden=H).as_model()
    grid4 = SweepGrid.build(("ring",), (0.0,), num_nodes=4)
    tree = GluADFL(model, get_optimizer("sgd", 0.1), FLConfig(num_nodes=N), device="cpu")
    with pytest.raises(ValueError, match="num_nodes"):
        tree.train_sweep(x, y, counts, grid=grid4)
    kernel = GluADFL(model, get_optimizer("sgd", 0.1), FLConfig(num_nodes=N), mixer="kernel",
                     device="cpu")
    with pytest.raises(NotImplementedError, match="kernel"):
        kernel.train_sweep(x, y, counts, grid=SweepGrid.build(("ring",), (0.0,), num_nodes=N))


# ------------------------------------------- the port's sweep vs its serial runs

SERIAL_CASES = [("dense", {}), ("sparse", {}),
                ("sparse", dict(schedules=("bernoulli", "markov"), skews=(0.0, 0.5),
                                dp_sigmas=(0.05,)))]


@pytest.mark.parametrize("gossip_repr,axes", SERIAL_CASES, ids=["dense", "sparse", "sparse-axes"])
def test_sweep_scenario_equals_its_serial_train_bitwise(gossip_repr, axes):
    """Scenario g of a port sweep from generators seeded ``seed_g`` is
    the port's serial ``train()`` of its config from a generator seeded
    ``seed_g``: on the CPU at these shapes, history, params, optimizer
    rows and staleness bit for bit.  (The contract is 1e-5: a static
    topology's serial run mixes over its candidate lists' table of
    min(B, C)+1 slots, the sweep over the adjacency's B+1, and at
    larger N the padding slots' zero terms can move a sum's last bit.)"""
    x, y, counts = toy_fed(seed=1)
    val = val_set()
    grid = SweepGrid.build(("ring", "random", "cluster"), (0.0, 0.4), (0, 3), num_nodes=N, **axes)
    sweep = GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer("adam", 1e-2),
                    FLConfig(num_nodes=N, comm_batch=COMM_BATCH), gossip_repr=gossip_repr,
                    device="cpu")
    pops, hists, states = sweep.train_sweep(x, y, counts, grid=grid, batch_size=BATCH,
                                            rounds=ROUNDS, chunk=CHUNK, eval_every=EVAL_EVERY,
                                            val_data=val)
    for g in range(grid.size):
        lab = grid.label_dict(g)
        cfg = FLConfig(topology=lab["topology"], num_nodes=N, comm_batch=COMM_BATCH,
                       inactive_ratio=lab["inactive_ratio"], schedule=lab["schedule"],
                       data_skew=lab["skew"])
        serial = GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer("adam", 1e-2), cfg,
                         gossip_repr=gossip_repr, dp_noise_sigma=lab["dp_sigma"], device="cpu")
        pop, hist, state = serial.train(torch.Generator().manual_seed(lab["seed"]), x, y, counts,
                                        batch_size=BATCH, rounds=ROUNDS, chunk=CHUNK,
                                        eval_every=EVAL_EVERY, val_data=val)
        assert hists[g] == hist, g
        assert torch.equal(states.params[g], state.params), g
        assert all(torch.equal(states.opt_state[k][g], state.opt_state[k]) for k in state.opt_state)
        assert torch.equal(states.staleness[g], state.staleness)
        assert all(torch.equal(tree_index(pops, g)[k], pop[k]) for k in pop)


@pytest.mark.parametrize("gossip_repr", ["dense", "sparse"])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_masked_sweep_is_bitwise_unmasked(gossip_repr, sigma):
    x, y, counts = toy_fed(seed=2)
    grid = SweepGrid.build(("ring", "random", "cluster"), (0.0, 0.4), (0, 1), num_nodes=N)
    runs = {}
    for impl in ("allgather", "masked"):
        trainer = GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer("adam", 1e-2),
                          FLConfig(num_nodes=N, comm_batch=COMM_BATCH), gossip_impl=impl,
                          gossip_repr=gossip_repr, dp_noise_sigma=sigma, device="cpu")
        runs[impl] = trainer.train_sweep(x, y, counts, grid=grid, batch_size=BATCH, rounds=4)
    (_, ha, a), (_, hb, b) = runs["allgather"], runs["masked"]
    assert ha == hb
    assert a.params.numpy().tobytes() == b.params.numpy().tobytes()
    assert all(torch.equal(a.opt_state[k], b.opt_state[k]) for k in a.opt_state)


def test_group_eval_is_bitwise_per_scenario_applies():
    """The sweep's eval forward: G populations over shared windows in
    one call equal G separate ``apply`` calls, bit for bit, and the
    records are each population's RMSE."""
    lstm = LSTMModel(hidden=H)
    gen = torch.Generator().manual_seed(0)
    rows = [lstm.init(gen) for _ in range(5)]
    stacked = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    vx, vy = (torch.from_numpy(a) for a in val_set(m=19))
    got = lstm.apply_groups(stacked, vx)
    assert got.shape == (5, 19)
    for g, params in enumerate(rows):
        assert torch.equal(got[g], lstm.apply(params, vx))
    trainer = GluADFL(lstm.as_model(), get_optimizer("sgd", 0.1), FLConfig(num_nodes=N),
                      device="cpu")
    pops = trainer.layout.flatten(stacked)
    rmse = trainer.sweep_val_rmse(pops, vx, vy)
    want = torch.stack([torch.sqrt(torch.mean(torch.square(lstm.apply(p, vx) - vy))) for p in rows])
    torch.testing.assert_close(rmse, want, rtol=0, atol=1e-6)


# -------------------------------------------------------------------- CLI


def test_cli_sweep_writes_the_jax_launchers_summary(tmp_path, capsys, monkeypatch):
    """``--sweep-ratios 0,0.5 --sweep-seeds 2``: four records with the
    JAX launcher's keys, the scenarios' own final losses, and the test
    forecasts as one G-group forward a patient (12 at OhioT1DM)."""
    calls = []
    plain = ref.lstm_forward_plain

    def counting(x, *weights):
        calls.append(tuple(x.shape))
        return plain(x, *weights)

    monkeypatch.setattr(ref, "lstm_forward_plain", counting)
    run = train_cli.run(["--device", "cpu", "--fast-data", "--hidden", "8", "--rounds", "4",
                         "--topology", "ring", "--sweep-ratios", "0,0.5", "--sweep-seeds", "2",
                         "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "sweep: 4 scenarios (ring x [0.0, 0.5] x 2 seeds)" in out
    records = json.loads((tmp_path / "sweep_ohiot1dm_ring.json").read_text())
    assert run.checkpoint == tmp_path / "sweep_ohiot1dm_ring.json" and records == run.summary
    metric_keys = set(jax_all_metrics(np.array([100.0, 120.0]), np.array([110.0, 118.0])))
    want_keys = {"topology", "inactive_ratio", "schedule", "skew", "dp_sigma", "seed",
                 "final_loss"} | metric_keys
    assert len(records) == 4 and all(set(r) == want_keys for r in records)
    assert [(r["inactive_ratio"], r["seed"]) for r in records] == [(0.0, 0), (0.0, 1), (0.5, 0),
                                                                  (0.5, 1)]
    assert [r["final_loss"] for r in records] == [h[-1]["loss"] for h in run.history]
    assert len(calls) == 12 and all(shape[0] == 4 for shape in calls)


@pytest.mark.parametrize("argv,reason", [
    (["--sweep-ratios", "0,0.5", "--mixer", "kernel"], "per-scenario"),
    (["--sweep-ratios", "0,0.5", "--chunk", "0"], "scan engine"),
    (["--sweep-ratios", "0,0.5", "--engine", "loop"], "scan engine"),
    (["--sweep-skews", "0,0.5"], "need --sweep-ratios"),
    (["--sweep-ratios", ","], "empty list"),
    (["--sweep-ratios", "0", "--sweep-seeds", "0"], "--sweep-seeds must be >= 1"),
])
def test_cli_sweep_refusals(argv, reason, capsys):
    assert train_cli.main(["--device", "cpu", "--fast-data", *argv]) == 2
    assert reason in capsys.readouterr().err
