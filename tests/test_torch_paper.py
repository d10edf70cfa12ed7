"""The port's paper experiments (``repro_torch.paper``) against the JAX
package's (``benchmarks/``), at a tiny scale on the CPU.

  * the Table-4 trainable-baseline grid dispatches <= 4 chunks through
    ``chunked.dispatch_chunk`` (as ``tests/test_baseline_engines.py``
    pins the JAX grid);
  * the RNG-free Table-4 rows (``lr``: the closed-form ridge solve;
    ``xgboost``: the same numpy tree fit) equal the JAX ``run`` rows
    within ``1e-4`` (metrics in mg/dL of float32 forecasts, |value| <
    100; the time lag exactly);
  * ``eval_population`` of an LSTM on JAX's params against the JAX
    experiment's (the same tolerance);
  * Fig 3's three rows against the JAX experiment's on one carried-over
    population, the scratch and fine-tune runs from JAX's init and
    batch indices (the same tolerance);
  * Tables 2 and 3 and Fig 3 run end to end and write their JSON under
    ``experiments/paper_torch/``, never ``experiments/paper/``;
  * the command line's ``--device`` and ``--full``.
"""
import dataclasses
import math
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch.core.chunked as chunked
from repro.models import LSTMModel as JaxLSTM
from repro_torch.models import LSTMModel, params_from_numpy
from repro_torch.paper import common, fig3_personalization, table2_generalization
from repro_torch.paper import table3_supervised, table4_baselines
from repro_torch.paper.common import Scale

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(rounds=2, sup_steps=16, max_patients=3, hidden=4, batch_size=8)
METRIC_ATOL = 1e-4


@pytest.fixture
def jax_bench(monkeypatch, tmp_path):
    """The JAX experiments' modules, writing under ``tmp_path``."""
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.common as jcommon
    import benchmarks.table4_baselines as jtable4

    monkeypatch.setattr(jcommon, "OUT_DIR", tmp_path / "jax")
    return jcommon, jtable4


@pytest.fixture
def out_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "OUT_DIR", tmp_path / "paper_torch")
    return tmp_path / "paper_torch"


def _assert_metrics_close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "time_lag":
            assert got[k] == want[k]
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=METRIC_ATOL, err_msg=k)


def test_baseline_grid_runs_in_at_most_four_dispatches(monkeypatch):
    calls = []
    orig = chunked.dispatch_chunk

    def counting(fn, *a, **k):
        calls.append(fn)
        return orig(fn, *a, **k)

    monkeypatch.setattr(chunked, "dispatch_chunk", counting)
    out = table4_baselines.run_baseline_grid("ohiot1dm", Scale(device="cpu", **TINY))
    assert set(out) == {"fedavg", "maml", "metasgd", "lstm"}
    assert len(calls) <= 4, f"{len(calls)} chunks"
    for method, d in out.items():
        assert len(d["history"]) == TINY["rounds"], method
        assert all(math.isfinite(h["loss"]) for h in d["history"]), method
        assert set(d["params"]) == {"b", "b_out", "w_out", "wh", "wx"}
    calls.clear()
    loop = table4_baselines.run_baseline_grid("ohiot1dm", Scale(device="cpu", **TINY),
                                              methods=("fedavg",), engine="loop")
    # the loop engine is the scan engine at one round a chunk
    assert len(calls) == TINY["rounds"]
    assert loop["fedavg"]["history"] == out["fedavg"]["history"]


def test_table4_rng_free_rows_match_jax(jax_bench, out_dir):
    jcommon, jtable4 = jax_bench
    datasets, methods = ["ohiot1dm", "abc4d"], ["lr", "xgboost"]
    want = jtable4.run(jcommon.Scale(**TINY), datasets=datasets, methods=methods)
    got = table4_baselines.run(Scale(device="cpu", **TINY), datasets=datasets, methods=methods)
    assert sorted(got) == sorted(want)
    for ds in datasets:
        assert sorted(got[ds]) == methods
        for m in methods:
            for part in ("seen", "unseen"):
                _assert_metrics_close(got[ds][m][part], want[ds][m][part])
    assert (out_dir / "table4_baselines.json").exists()


def test_eval_population_matches_jax(jax_bench):
    jcommon, _ = jax_bench
    jparams = JaxLSTM(hidden=4).init(jax.random.PRNGKey(0))
    want = jcommon.eval_population(JaxLSTM(hidden=4).as_model(), jparams,
                                   jcommon.load("ohiot1dm", jcommon.Scale(**TINY)))
    got = common.eval_population(LSTMModel(hidden=4).as_model(),
                                 params_from_numpy(jparams, "cpu"),
                                 common.load("ohiot1dm", Scale(device="cpu", **TINY)))
    _assert_metrics_close(got, want)


def _jax_key_indices(key, steps: int, batch: int, hi: int) -> tuple:
    """``(key, [(batch,) indices] * steps)``: one ``split`` then one
    ``randint`` per step, the order of JAX's supervised and fine-tune
    steps."""
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(torch.as_tensor(np.array(jax.random.randint(sub, (batch,), 0, hi)),
                                   dtype=torch.int64))
    return key, out


def test_fig3_rows_match_jax_from_jax_draws(jax_bench, out_dir, monkeypatch):
    """Fig 3 from one population carried over from JAX: the population
    row takes no draw; patient i's scratch run takes JAX's init and
    batches from ``PRNGKey(1000 + i)`` as ``train_supervised`` splits it,
    and its fine-tune the batches ``personalize`` draws from that key."""
    jcommon, _ = jax_bench
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.fig3_personalization as jfig3

    scale = {**TINY, "max_patients": 2}
    jmodel = JaxLSTM(hidden=4)
    jpop = jmodel.init(jax.random.PRNGKey(3))
    monkeypatch.setattr(jfig3, "train_gluadfl", lambda ds, sc, **kw: (
        jmodel.as_model(), jpop, [], jcommon.load(ds, sc)))
    monkeypatch.setattr(fig3_personalization, "train_gluadfl", lambda ds, sc, **kw: (
        LSTMModel(hidden=4).as_model(), params_from_numpy(jpop, "cpu"), [], common.load(ds, sc)))
    scratch_i, tune_i = iter(range(scale["max_patients"])), iter(range(scale["max_patients"]))
    train_supervised = fig3_personalization.train_supervised

    def scratch_from_jax(model, opt, generator, x, y, *, steps, batch_size, **kw):
        key, k_init = jax.random.split(jax.random.PRNGKey(1000 + next(scratch_i)))
        _, draws = _jax_key_indices(key, steps, batch_size, len(x))
        return train_supervised(model, opt, None, x, y, steps=steps, batch_size=batch_size,
                                params=params_from_numpy(jmodel.init(k_init), "cpu"),
                                draws=draws, **kw)

    def tune_from_jax(generator, counts, n_rows, steps, batch_size):
        key = jax.random.PRNGKey(1000 + next(tune_i))
        _, idx = _jax_key_indices(key, steps, min(batch_size, n_rows), int(counts[0]))
        return torch.stack(idx)[None]

    monkeypatch.setattr(fig3_personalization, "train_supervised", scratch_from_jax)
    monkeypatch.setattr(fig3_personalization, "draw_personalize", tune_from_jax)
    want = jfig3.run(jcommon.Scale(**scale), datasets=["ohiot1dm"])["ohiot1dm"]
    got = fig3_personalization.run(Scale(device="cpu", **scale), datasets=["ohiot1dm"])["ohiot1dm"]
    assert next(scratch_i, None) is None and next(tune_i, None) is None
    assert sorted(got) == sorted(want) == ["pers_from_pop", "personalized", "population"]
    for row in want:
        _assert_metrics_close(got[row], want[row])
    assert got["pers_from_pop"] != got["population"]


def test_tables_2_3_and_fig3_run_and_write_under_paper_torch(out_dir):
    scale = Scale(device="cpu", **{**TINY, "max_patients": 2})
    t2 = table2_generalization.run(scale)
    t3 = table3_supervised.run(scale)
    f3 = fig3_personalization.run(scale, datasets=["ohiot1dm"])
    # sup_steps < 8: the fine-tune takes no step, so it keeps the population
    f3_short = fig3_personalization.run(dataclasses.replace(scale, sup_steps=4),
                                        datasets=["ohiot1dm"])["ohiot1dm"]
    assert f3_short["pers_from_pop"] == f3_short["population"]
    for rows in (t2["rows"], t3["rows"]):
        assert sorted(rows) == sorted(common.DATASETS)
        assert all(sorted(r) == sorted(common.DATASETS) for r in rows.values())
        assert all(math.isfinite(m["rmse"]) for r in rows.values() for m in r.values())
    assert math.isfinite(t2["mean_unseen_minus_seen_rmse"])
    assert sorted(f3["ohiot1dm"]) == ["pers_from_pop", "personalized", "population"]
    assert all(math.isfinite(v["rmse"]) for v in f3["ohiot1dm"].values())
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "fig3_personalization.json", "table2_generalization.json", "table3_supervised.json"]


def test_results_go_to_paper_torch_not_to_the_jax_experiments():
    assert common.OUT_DIR == ROOT / "experiments" / "paper_torch"
    assert "experiments/paper_torch/" in (ROOT / ".gitignore").read_text().splitlines()


def test_command_line_scale_and_device(monkeypatch):
    assert common.parse_scale(["--device", "cpu"], "") == Scale(device="cpu")
    full = common.parse_scale(["--full"], "")
    assert full.device is None and (full.rounds, full.max_patients, full.hidden) == (
        1000, None, 128)
    seen = []
    assert common.main(seen.append, ["--device", "cpu"], "") == 0
    assert seen == [Scale(device="cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        table4_baselines.run_baseline_grid("ohiot1dm", Scale(**TINY))


def test_preload_hands_load_the_given_dataset(monkeypatch):
    monkeypatch.setattr(common, "_FED_CACHE", {})
    fed = common.load("ohiot1dm", Scale(device="cpu", **TINY))
    common.preload(fed, max_patients=None)
    assert common.load("ohiot1dm", Scale(device="cpu", **{**TINY, "max_patients": None})) is fed
    assert common.load("abc4d", Scale(device="cpu", **TINY)) is not fed
