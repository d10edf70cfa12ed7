"""The streaming ``eval_fn`` of the port's ``GluADFL.train`` and
``train_sweep``, and the Fig-4 / Fig-5 experiments
(``repro_torch.paper.fig4_topology``, ``fig5_async``), against the JAX
package's, at a tiny scale on the CPU.

The JAX trainers run from their keys; the port's from JAX's initial
params and JAX's draws, split here in ``GluADFL._round``'s order
(``tests/test_torch_train.py:jax_draws`` for one run,
``tests/test_torch_sweep.py:jax_sweep_draws`` per scenario).

Tolerances:
  * ``eval_fn`` records on ``train`` and ``train_sweep`` under SGD: the
    losses and every eval value within ``atol=2e-6``, as the five-round
    parity of ``tests/test_torch_train.py`` holds its val RMSE (fp32
    summation order of the gradient and the gossip, over a few rounds);
  * the figures (Adam 2e-3, as the experiments train): every mg/dL
    value within ``METRIC_ATOL = 1e-4``, as ``tests/test_torch_paper.py``
    holds the other figures;
  * the port against itself (chunks, engines, the sweep's default eval
    against per-scenario calls): bitwise.

Torch runs on one thread here: its small ops slow down many times over
when the suite's workers share the cores.
"""
import dataclasses
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JaxFLConfig
from repro.core import GluADFL as JaxGluADFL
from repro.core import SweepGrid as JaxSweepGrid
from repro.models import LSTMModel as JaxLSTM
from repro.optim import adam as jax_adam
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.config import FLConfig
from repro_torch.core import GluADFL, SweepGrid
from repro_torch.models import LSTMModel
from repro_torch.optim import get_optimizer
from repro_torch.paper import common, fig4_topology, fig5_async
from repro_torch.paper.common import Scale
from repro_torch.utils.pytree import tree_index
from test_torch_sweep import BATCH as SWEEP_BATCH
from test_torch_sweep import COMM_BATCH, jax_sweep_draws, toy_fed, val_set
from test_torch_train import BATCH, H, _data, _pair, jax_draws

ROOT = Path(__file__).resolve().parents[1]
FIG = dict(rounds=3, sup_steps=16, max_patients=6, hidden=4, batch_size=SWEEP_BATCH)
METRIC_ATOL = 1e-4
EVAL_ATOL = 2e-6
N = 6


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ eval_fns

def jax_eval(p, vx, vy):
    """A traceable eval of two keys: the val MAE and a weight sum."""
    pred = JaxLSTM(hidden=H).as_model().apply(p, vx)
    return {"val_mae": jnp.mean(jnp.abs(pred - vy)), "w_out_sum": jnp.sum(p["w_out"])}


def port_eval(p, vx, vy):
    with torch.no_grad():
        pred = LSTMModel(hidden=H).as_model().apply(p, vx)
        return {"val_mae": torch.mean(torch.abs(pred - vy)), "w_out_sum": torch.sum(p["w_out"])}


def jax_norm(p):
    """The 1-argument form, which needs no val set."""
    return {"wh_norm": jnp.sqrt(jnp.sum(jnp.square(p["wh"])))}


def port_norm(p):
    return {"wh_norm": float(torch.sqrt(torch.sum(torch.square(p["wh"]))))}


def _chain(key, n, counts, rounds, batch=BATCH):
    for _ in range(rounds):
        key, draws = jax_draws(key, n, counts, random_topology=True, batch=batch)
        yield draws


def _records(hist, keys):
    return [(h["round"], *(h[k] for k in keys)) for h in hist if keys[0] in h]


EVAL_FORMS = {
    "three_args": (jax_eval, port_eval, True),
    "one_arg_without_val_data": (jax_norm, port_norm, False),
}


@pytest.mark.parametrize("form", sorted(EVAL_FORMS))
def test_train_eval_fn_matches_jax_from_jax_draws(form):
    jfn, fn, with_val = EVAL_FORMS[form]
    rounds, n = 5, N
    x, y, counts = _data(n, seed=3)
    val = tuple(a[:2].reshape(-1, *a.shape[2:]) for a in (x, y)) if with_val else None
    jt, tt = _pair(n, "sgd", dict(topology="random"), mixer="tree", gossip_repr="dense")
    key = jax.random.PRNGKey(5)
    kw = dict(batch_size=BATCH, rounds=rounds, eval_every=2, val_data=val)
    _, jhist, _ = jt.train(key, x, y, counts, eval_fn=jfn, **kw)
    init = jt.init(key)
    state = tt.state_from_params({k: np.asarray(v) for k, v in init.params.items()})
    _, hist, _ = tt.train(None, x, y, counts, eval_fn=fn, chunk=2, state=state,
                          draws=_chain(init.key, n, counts, rounds), **kw)
    assert [sorted(h) for h in hist] == [sorted(h) for h in jhist]
    keys = sorted(set(jhist[1]) - {"round", "loss"})
    got, want = np.array(_records(hist, keys)), np.array(_records(jhist, keys))
    assert got[:, 0].tolist() == [1, 3]
    np.testing.assert_allclose(got, want, rtol=0, atol=EVAL_ATOL)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=0, atol=EVAL_ATOL)


def _port_run(eval_fn=port_eval, val=True, **kw):
    x, y, counts = _data(N, seed=4)
    _, tt = _pair(N, "sgd", dict(topology="random"), mixer="tree", gossip_repr="dense")
    return tt.train(torch.Generator().manual_seed(0), x, y, counts, batch_size=BATCH, rounds=7,
                    eval_every=3, eval_fn=eval_fn, val_data=(x[0], y[0]) if val else None, **kw)


def test_eval_keys_only_on_boundary_rounds():
    _, hist, _ = _port_run()
    for h in hist:
        boundary = (h["round"] + 1) % 3 == 0
        assert set(h) == ({"round", "loss", "val_mae", "w_out_sum"} if boundary
                          else {"round", "loss"})
    assert [h["round"] for h in hist if "val_mae" in h] == [2, 5]
    # eval_every=0, or neither eval_fn nor val_data: no eval at all
    assert all(set(h) == {"round", "loss"} for h in _port_run(eval_fn=None, val=False)[1])
    x, y, counts = _data(N, seed=4)
    _, tt = _pair(N, "sgd", dict(topology="random"), mixer="tree", gossip_repr="dense")
    hist = tt.train(torch.Generator().manual_seed(0), x, y, counts, batch_size=BATCH, rounds=3,
                    eval_fn=port_eval, val_data=(x[0], y[0]))[1]
    assert all(set(h) == {"round", "loss"} for h in hist)


@pytest.mark.parametrize("engine", ["scan", "loop"])
def test_history_does_not_depend_on_chunk_or_engine(engine):
    """``chunk`` 1, 3 and the default, and ``engine="loop"`` (one round
    a chunk): the same history and params, bit for bit."""
    base_pop, base, base_state = _port_run(chunk=3)
    for chunk in (1, None):
        pop, hist, state = _port_run(chunk=chunk, engine=engine)
        assert hist == base
        assert torch.equal(state.params, base_state.params)
        assert all(torch.equal(pop[k], base_pop[k]) for k in pop)


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="engine"):
        _port_run(engine="while")


@pytest.mark.parametrize("bad,match", [
    (lambda p, vx, vy: 1.0, "must return a dict of float scalars, got float"),
    (lambda p, vx, vy: [torch.zeros(())], "got list"),
    (lambda p, vx, vy: {"n": 3}, r"output 'n' must be a floating SCALAR .* got int\(\)"),
    (lambda p, vx, vy: {"n": torch.tensor(3)}, r"got int64\(\)"),
    (lambda p, vx, vy: {"v": torch.zeros(2)}, r"output 'v' must be a floating SCALAR .* "
                                               r"got float32\(2,\)"),
    (lambda p, vx, vy: {"v": torch.zeros(1)}, r"got float32\(1,\)"),
])
def test_eval_fn_result_type_errors(bad, match):
    with pytest.raises(TypeError, match=match):
        _port_run(eval_fn=bad)


def test_eval_fn_takes_floats_and_host_callbacks():
    """A Python float, a float64 tensor and a numpy float are all floats;
    a host-side callback with side effects is allowed (eager eval)."""
    seen = []

    def host(p):
        seen.append(float(p["b_out"][0]))
        return {"f": 0.5, "t64": torch.tensor(0.25, dtype=torch.float64), "np": np.float32(2.0)}

    _, hist, _ = _port_run(eval_fn=host, val=False)
    recs = [h for h in hist if "f" in h]
    assert len(seen) == len(recs) == 2
    assert all((h["f"], h["t64"], h["np"]) == (0.5, 0.25, 2.0) for h in recs)


# ------------------------------------------------------------- sweeps

def _sweep_pair():
    cfg = dict(num_nodes=N, comm_batch=COMM_BATCH)
    jt = JaxGluADFL(JaxLSTM(hidden=H).as_model(), jax_get_optimizer("sgd", 1e-2),
                    JaxFLConfig(**cfg))
    tt = GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer("sgd", 1e-2), FLConfig(**cfg),
                 device="cpu")
    return jt, tt


@pytest.mark.parametrize("form", ["three_args", "one_arg_without_val_data"])
def test_train_sweep_eval_fn_matches_jax_per_scenario(form):
    jfn, fn, with_val = EVAL_FORMS[form]
    x, y, counts = toy_fed()
    val = val_set() if with_val else None
    topos, ratios = ("ring", "random"), (0.0, 0.5)
    jgrid = JaxSweepGrid.build(topos, ratios, (0, 1), num_nodes=N)
    grid = SweepGrid.build(topos, ratios, (0, 1), num_nodes=N)
    jt, tt = _sweep_pair()
    rounds, kw = 4, dict(batch_size=SWEEP_BATCH, eval_every=2, val_data=val)
    _, jhists, _ = jt.train_sweep(x, y, counts, grid=jgrid, rounds=rounds, chunk=3,
                                  eval_fn=jfn, **kw)
    init = jt._sweep_init_jit(jgrid.init_keys)
    states = tt.state_from_params({k: np.asarray(v) for k, v in init.params.items()})
    _, hists, _ = tt.train_sweep(x, y, counts, grid=grid, rounds=rounds, chunk=3, eval_fn=fn,
                                 states=states, draws=jax_sweep_draws(init.key, jgrid, counts,
                                                                      rounds), **kw)
    assert len(hists) == grid.size == 8
    for hist, jhist in zip(hists, jhists):
        assert [sorted(h) for h in hist] == [sorted(h) for h in jhist]
        keys = sorted(set(jhist[1]) - {"round", "loss"})
        assert [r[0] for r in _records(hist, keys)] == [1, 3]
        np.testing.assert_allclose(_records(hist, keys), _records(jhist, keys), rtol=0,
                                   atol=EVAL_ATOL)
        np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                                   rtol=0, atol=EVAL_ATOL)


def _counting_trainer(calls):
    model = LSTMModel(hidden=H).as_model()

    def groups(stacked, x):
        calls.append(("apply_groups", next(iter(stacked.values())).shape[0]))
        return model.apply_groups(stacked, x)

    def apply(params, x):
        calls.append(("apply", 1))
        return model.apply(params, x)

    counted = dataclasses.replace(model, apply=apply, apply_groups=groups)
    return GluADFL(counted, get_optimizer("sgd", 1e-2),
                   FLConfig(num_nodes=N, comm_batch=COMM_BATCH), device="cpu")


def test_sweep_default_eval_is_one_grouped_forward_and_eval_fn_one_call_a_scenario():
    """``eval_fn=None``: one ``apply_groups`` of all G populations per
    eval round; a caller's eval_fn: G calls on ``tree_index(pops, g)``,
    whose val RMSE is the default's record, bit for bit."""
    x, y, counts = toy_fed()
    vx, vy = val_set()
    grid = SweepGrid.build(("ring", "cluster", "random"), (0.0, 0.5), (0,), num_nodes=N)
    runs = {}
    for name in ("default", "eval_fn"):
        calls = []
        tt = _counting_trainer(calls)
        fn = None if name == "default" else (lambda p, a, b, tt=tt: tt._default_eval_metrics(p, a, b))
        pops, hists, _ = tt.train_sweep(x, y, counts, grid=grid, batch_size=SWEEP_BATCH,
                                        rounds=4, eval_every=2, eval_fn=fn, val_data=(vx, vy),
                                        generators=[torch.Generator().manual_seed(s)
                                                    for s in range(grid.size)])
        runs[name] = (calls, hists, pops)
    calls, hists, pops = runs["default"]
    assert calls == [("apply_groups", 6)] * 2
    assert runs["eval_fn"][0] == [("apply", 1)] * 12
    assert runs["eval_fn"][1] == hists
    for g in range(grid.size):
        want = torch.sqrt(torch.mean(torch.square(
            LSTMModel(hidden=H).as_model().apply(tree_index(pops, g), torch.from_numpy(vx))
            - torch.from_numpy(vy))))
        assert hists[g][-1]["val_rmse"] == float(want)


# ------------------------------------------------------------ figures

@pytest.fixture
def jax_fig(monkeypatch, tmp_path):
    """The JAX experiments' modules, writing under ``tmp_path``."""
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.common as jcommon
    import benchmarks.fig4_topology as jfig4
    import benchmarks.fig5_async as jfig5

    monkeypatch.setattr(jcommon, "OUT_DIR", tmp_path / "jax")
    return jcommon, jfig4, jfig5


@pytest.fixture
def out_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "OUT_DIR", tmp_path / "paper_torch")
    return tmp_path / "paper_torch"


def _jax_twin(tr: GluADFL) -> JaxGluADFL:
    """The JAX trainer of ``tr``'s config, as the figures build it (the
    LSTM of ``tr``'s width, Adam 2e-3)."""
    hidden = tr.layout.shapes[tr.layout.names.index("wh")][0]
    return JaxGluADFL(JaxLSTM(hidden=hidden).as_model(), jax_adam(2e-3),
                      JaxFLConfig(**dataclasses.asdict(tr.cfg)))


@pytest.fixture
def jax_draws_in_port(monkeypatch):
    """The port's ``train`` and ``train_sweep`` start from the JAX
    trainer's initial params and take its draws, for the key the JAX
    experiments pass (``PRNGKey(cfg.seed)``; a grid's ``init_keys``)."""
    train, train_sweep = GluADFL.train, GluADFL.train_sweep

    def jax_train(self, generator, x, y, counts, **kw):
        init = _jax_twin(self).init(jax.random.PRNGKey(self.cfg.seed))
        state = self.state_from_params({k: np.asarray(v) for k, v in init.params.items()})

        def draws():
            key = init.key
            for _ in range(kw.get("rounds") or self.cfg.rounds):
                key, d = jax_draws(key, self.cfg.num_nodes, counts, batch=kw["batch_size"],
                                   random_topology=self.cfg.topology == "random")
                yield d
        return train(self, None, x, y, counts, state=state, draws=draws(), **kw)

    def jax_sweep(self, x, y, counts, *, grid, **kw):
        axes = [list(dict.fromkeys(lab[i] for lab in grid.labels)) for i in range(3)]
        jgrid = JaxSweepGrid.build(*axes, num_nodes=self.cfg.num_nodes)
        assert jgrid.labels == grid.labels and kw["batch_size"] == SWEEP_BATCH
        init = _jax_twin(self)._sweep_init_jit(jgrid.init_keys)
        states = self.state_from_params({k: np.asarray(v) for k, v in init.params.items()})
        draws = jax_sweep_draws(init.key, jgrid, counts, kw.get("rounds") or self.cfg.rounds)
        return train_sweep(self, x, y, counts, grid=grid, states=states, draws=draws, **kw)

    monkeypatch.setattr(GluADFL, "train", jax_train)
    monkeypatch.setattr(GluADFL, "train_sweep", jax_sweep)


def _close_curves(got, want):
    assert sorted(got) == sorted(want)
    for topo in want:
        g, w = np.array(got[topo], np.float64), np.array(want[topo], np.float64)
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=METRIC_ATOL, err_msg=topo)


@pytest.mark.parametrize("serial", [False, True], ids=["sweep", "serial"])
def test_fig4_matches_jax_from_jax_draws(jax_fig, out_dir, jax_draws_in_port, serial):
    jcommon, jfig4, _ = jax_fig
    kw = dict(datasets=["ohiot1dm"], eval_every=1, serial=serial)
    want = jfig4.run(jcommon.Scale(**FIG), **kw)
    got = fig4_topology.run(Scale(device="cpu", **FIG), **kw)
    _close_curves(got["ohiot1dm"], want["ohiot1dm"])
    assert [r for r, _ in got["ohiot1dm"]["ring"]] == [0, 1, 2]
    # the JSON under experiments/paper_torch/, the JAX file's layout
    written = json.loads((out_dir / "fig4_topology.json").read_text())
    jwritten = json.loads((jcommon.OUT_DIR / "fig4_topology.json").read_text())
    assert sorted(written["ohiot1dm"]) == sorted(jwritten["ohiot1dm"]) == sorted(
        fig4_topology.TOPOLOGIES)
    assert [len(p) for p in written["ohiot1dm"]["ring"]] == [2, 2, 2]


@pytest.mark.parametrize("serial", [False, True], ids=["sweep", "serial"])
def test_fig5_matches_jax_from_jax_draws(jax_fig, out_dir, jax_draws_in_port, serial):
    jcommon, _, jfig5 = jax_fig
    # the serial path trains (and JAX compiles) one run a scenario: 3 here
    kw = dict(datasets=["ohiot1dm"], ratios=[0.7] if serial else [0.0, 0.7], serial=serial)
    want = jfig5.run(jcommon.Scale(**FIG), **kw)
    got = fig5_async.run(Scale(device="cpu", **FIG), **kw)
    _close_curves(got["ohiot1dm"], want["ohiot1dm"])
    written = json.loads((out_dir / "fig5_async.json").read_text())
    jwritten = json.loads((jcommon.OUT_DIR / "fig5_async.json").read_text())
    assert written.keys() == jwritten.keys()
    assert {t: [r for r, _ in c] for t, c in written["ohiot1dm"].items()} == {
        t: [r for r, _ in c] for t, c in jwritten["ohiot1dm"].items()}


def test_figures_sweep_equals_serial_in_the_port(out_dir, capsys):
    """Without JAX: the batched and the serial path of each figure give
    the same curves on the CPU (the same seeded draws), the printed
    convergence order and the 70%-inactive line."""
    scale = Scale(device="cpu", **FIG)
    for mod, kw in ((fig4_topology, dict(eval_every=1)), (fig5_async, dict(ratios=[0.0, 0.7]))):
        sweep = mod.run(scale, datasets=["ohiot1dm"], **kw)["ohiot1dm"]
        serial = mod.run(scale, datasets=["ohiot1dm"], serial=True, **kw)["ohiot1dm"]
        for topo in sweep:
            np.testing.assert_allclose(sweep[topo], serial[topo], rtol=0, atol=METRIC_ATOL)
            assert all(math.isfinite(v) for _, v in sweep[topo])
    out = capsys.readouterr().out
    assert "convergence order:" in out and "(paper: random < cluster < ring)" in out
    assert "RMSE at 70% inactive vs active:" in out
    assert sorted(p.name for p in out_dir.iterdir()) == ["fig4_topology.json", "fig5_async.json"]


def test_figure_command_lines(monkeypatch):
    seen = []
    for mod in (fig4_topology, fig5_async):
        monkeypatch.setattr(mod, "run", lambda scale, serial=False: seen.append((scale, serial)))
        assert mod.main(["--device", "cpu", "--serial"]) == 0
        assert mod.main(["--device", "cpu", "--full"]) == 0
    assert seen == [(Scale(device="cpu"), True), (dataclasses.replace(Scale.full(), device="cpu"),
                                                   False)] * 2
