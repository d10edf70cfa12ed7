"""The port's baseline trainers (FedAvg, MAML/MetaSGD, pooled supervised)
against ``repro.core.fedavg``, ``repro.core.meta`` and
``repro.core.supervised``.

The draws are made with ``jax.random`` in the JAX trainers' split order
and handed to the port with JAX's initial params, so both packages take
the same steps on the same windows:
  * FedAvg: ``key, k_init = split(key)``; each round ``key, k_act, k_cli
    = split(key, 3)``, ``uniform(k_act, (N,))``, then ``split(k_cli, N)``
    -> ``split(client_key, local_steps)`` -> ``randint(k, (B,), 0,
    max(count, 1))``;
  * MAML/MetaSGD: ``key, k_init = split(key)``; each step ``key, sub =
    split(key)``, ``split(sub, 2N).reshape(N, 2, -1)``, the support
    ``split(keys[n, 0], inner_steps)`` -> ``randint``, the query
    ``randint(keys[n, 1])``;
  * supervised: ``key, k_init = split(key)``; each step ``key, sub =
    split(key)``, ``randint(sub, (B,), 0, R)``.
Then the pins of ``tests/test_baselines.py`` and
``tests/test_baseline_engines.py`` on the port alone.

Tolerances, on fp32 values of magnitude ~1, as in
``tests/test_torch_train.py``'s header (the gradient's summation order
differs: autograd of batched matmuls against ``jax.grad`` of a
``vmap``):
  * SGD: losses, val records and params within ``atol=1e-5``;
  * Adam: losses within ``atol=1e-4`` and params within a relative norm
    of ``1e-3`` (``mhat / (sqrt(vhat) + eps)`` amplifies the roundoff of
    a gradient element near zero, up to a sign flip);
  * MAML/MetaSGD (Adam 1e-3, or SGD 0.5, on the meta-params, two
    steps): params, ``lrs`` and losses within ``atol=1e-5``;
  * the port's engines against each other, and active clients with and
    without a poisoned inactive shard: bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.core.chunked as chunked
from repro.config import FLConfig as JaxFLConfig
from repro.core.fedavg import FedAvg as JaxFedAvg
from repro.core.meta import MAML as JaxMAML
from repro.core.meta import MetaSGD as JaxMetaSGD
from repro.core.supervised import train_supervised as jax_train_supervised
from repro.models import LSTMModel as JaxLSTM
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.config import FLConfig
from repro_torch.core import MAML, FedAvg, MetaSGD, train_supervised
from repro_torch.core.async_sched import bernoulli_active
from repro_torch.core.gluadfl import FedTensors
from repro_torch.models import LSTMModel, params_from_numpy
from repro_torch.optim import get_optimizer
from repro_torch.utils.pytree import tree_to_vector
from repro_torch.utils.rng import MetaDraws, RoundDraws, draw_meta, draw_round, draw_supervised

H, L, BATCH = 4, 12, 8
LR = {"sgd": 1e-2, "adam": 1e-3}


def _fed(n=5, m=30, seed=0, counts=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m, L)).astype(np.float32)
    y = (x @ rng.normal(size=L).astype(np.float32) * 0.3).astype(np.float32)
    counts = np.asarray(counts if counts is not None else rng.integers(m // 2, m + 1, size=n),
                        np.int32)
    return x, y, counts


def _val(m=16, seed=7):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, L)).astype(np.float32), rng.normal(size=m).astype(np.float32)


def _jax_params(key):
    return JaxLSTM(hidden=H).init(key)


def _vec(tree):
    """A JAX param tree or a port param dict as one sorted-key vector."""
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in sorted(tree)])


def _t(a, dtype=None):
    return torch.from_numpy(np.array(a, dtype=dtype))


def _model():
    return LSTMModel(hidden=H).as_model()


# ------------------------------------------------------------- JAX draws

@functools.partial(jax.jit, static_argnums=(2, 3))
def _client_idx(k_cli, counts, local_steps, batch):
    def client(key, c):
        return jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, jnp.maximum(c, 1)))(
            jax.random.split(key, local_steps))
    return jax.vmap(client)(jax.random.split(k_cli, counts.shape[0]), counts)


def jax_fedavg_draws(key, counts, rounds, local_steps):
    """``(k_init, [RoundDraws] * rounds)`` in ``FedAvg.train``'s order."""
    key, k_init = jax.random.split(key)
    out = []
    for _ in range(rounds):
        key, k_act, k_cli = jax.random.split(key, 3)
        u = jax.random.uniform(k_act, (len(counts),))
        idx = _client_idx(k_cli, jnp.asarray(counts, jnp.int32), local_steps, BATCH)
        out.append(RoundDraws(_t(u), None, _t(idx, np.int64)))
    return k_init, out


@functools.partial(jax.jit, static_argnums=(2, 3))
def _meta_idx(sub, counts, inner_steps, batch):
    n = counts.shape[0]
    keys = jax.random.split(sub, 2 * n).reshape(n, 2, -1)

    def task(tk, c):
        hi = jnp.maximum(c, 1)
        support = jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, hi))(
            jax.random.split(tk[0], inner_steps))
        return support, jax.random.randint(tk[1], (batch,), 0, hi)
    return jax.vmap(task)(keys, counts)


def jax_meta_draws(key, counts, steps, inner_steps):
    """``(k_init, [MetaDraws] * steps)`` in ``MAML.train``'s order."""
    key, k_init = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        support, query = _meta_idx(sub, jnp.asarray(counts, jnp.int32), inner_steps, BATCH)
        out.append(MetaDraws(_t(support, np.int64), _t(query, np.int64)))
    return k_init, out


def jax_supervised_draws(key, rows, steps):
    """``(k_init, [(B,) indices] * steps)`` in ``train_supervised``'s order."""
    key, k_init = jax.random.split(key)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(_t(jax.random.randint(sub, (BATCH,), 0, rows), np.int64))
    return k_init, out


def _close(got, want, opt):
    got, want = np.asarray(got), np.asarray(want)
    if opt == "sgd":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


def _losses(hist, key="val_loss"):
    return (np.array([h["loss"] for h in hist]),
            [(h.get("round", h.get("step")), h[key]) for h in hist if key in h])


# ---------------------------------------------------------------- FedAvg

@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fedavg_three_rounds_match_jax(opt):
    x, y, counts = _fed()
    vx, vy = _val()
    cfg = dict(num_nodes=5, rounds=3, inactive_ratio=0.3, local_steps=2)
    key = jax.random.PRNGKey(11)
    jp, jhist = JaxFedAvg(JaxLSTM(hidden=H).as_model(), jax_get_optimizer(opt, LR[opt]),
                          JaxFLConfig(**cfg)).train(key, x, y, counts, batch_size=BATCH,
                                                    engine="loop", val_data=(vx, vy),
                                                    eval_every=1)
    k_init, draws = jax_fedavg_draws(key, counts, 3, 2)
    assert any(float(d.u_act.min()) < 0.3 for d in draws)  # some rounds drop clients
    fa = FedAvg(_model(), get_optimizer(opt, LR[opt]), FLConfig(**cfg), device="cpu")
    params, hist = fa.train(None, x, y, counts, batch_size=BATCH, val_data=(vx, vy),
                            eval_every=1, params=params_from_numpy(_jax_params(k_init), "cpu"),
                            draws=draws)
    assert [sorted(h) for h in hist] == [sorted(h) for h in jhist]
    (losses, vals), (jlosses, jvals) = _losses(hist), _losses(jhist)
    atol = 1e-5 if opt == "sgd" else 1e-4
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=atol)
    np.testing.assert_allclose([v for _, v in vals], [v for _, v in jvals], rtol=0, atol=atol)
    _close(_vec(params), _vec(jp), opt)


def test_fedavg_aggregation_is_counts_weighted_mean():
    x, y, counts = _fed(n=4, m=40, counts=[10, 20, 40, 10])
    fa = FedAvg(_model(), get_optimizer("sgd", 1e-2),
                FLConfig(num_nodes=4, inactive_ratio=0.0, local_steps=2), device="cpu")
    data = FedTensors.of(x, y, counts, "cpu")
    params = tree_to_vector(fa.model.init(torch.Generator().manual_seed(1)))
    draws = draw_round(torch.Generator().manual_seed(3), data.counts, local_steps=2,
                       batch_size=BATCH, random_topology=False)
    new, _ = fa.round(params, data, draws)
    cp, _ = fa.client_update(params, data, torch.ones(4), draws.batch_idx)
    w = counts / counts.sum()
    oracle = (w[:, None] * cp.numpy().astype(np.float64)).sum(axis=0)
    np.testing.assert_allclose(new.numpy(), oracle, rtol=1e-5, atol=1e-6)


def test_fedavg_inactive_clients_are_inert():
    """A poisoned (NaN) shard of an inactive client leaves the round's
    params and loss finite, and the active clients' result bitwise as on
    clean data."""
    x, y, counts = _fed(n=6)
    fa = FedAvg(_model(), get_optimizer("adam", 1e-2),
                FLConfig(num_nodes=6, inactive_ratio=0.5, local_steps=2), device="cpu")
    params = tree_to_vector(fa.model.init(torch.Generator().manual_seed(1)))
    draws = draw_round(torch.Generator().manual_seed(0), torch.as_tensor(counts), local_steps=2,
                       batch_size=BATCH, random_topology=False)
    active = bernoulli_active(draws.u_act, 0.5).numpy()
    assert 0 < active.sum() < 6, "the seed must give a mixed active set"
    poisoned = x.copy()
    poisoned[active == 0] = np.nan
    clean_data, bad_data = (FedTensors.of(a, y, counts, "cpu") for a in (x, poisoned))
    new, loss = fa.round(params, bad_data, draws)
    assert bool(torch.isfinite(new).all()) and np.isfinite(float(loss))
    clean, clean_loss = fa.round(params, clean_data, draws)
    assert torch.equal(new, clean) and float(loss) == float(clean_loss)
    cp_bad, _ = fa.client_update(params, bad_data, torch.from_numpy(active), draws.batch_idx)
    cp_clean, _ = fa.client_update(params, clean_data, torch.from_numpy(active), draws.batch_idx)
    assert torch.equal(cp_bad, cp_clean)
    assert torch.equal(cp_bad[active == 0], params[None].expand(int((active == 0).sum()), -1))


def test_fedavg_epochs_resolve_to_data_coverage_steps():
    cfg = FLConfig(num_nodes=2, local_steps=1)
    fa = FedAvg(_model(), get_optimizer("sgd", 1e-2), cfg, local_epochs=3, device="cpu")
    assert fa.resolve_local_steps([200, 50], batch_size=64) == 12
    assert FedAvg(_model(), get_optimizer("sgd", 1e-2), cfg, device="cpu").resolve_local_steps(
        [200], 64) == 1
    with pytest.raises(ValueError, match="local_epochs"):
        FedAvg(_model(), get_optimizer("sgd", 1e-2), cfg, local_epochs=0, device="cpu")


def test_fedavg_epochs_match_equivalent_steps_bitwise():
    """2 epochs over 100 windows at batch 64 are 4 steps: bitwise the
    run configured with 4 steps (the same draws, the same step count)."""
    x, y, counts = _fed(n=3, m=100, counts=[100, 100, 100])
    runs = []
    for cfg, epochs in ((FLConfig(num_nodes=3, local_steps=4), None),
                        (FLConfig(num_nodes=3, local_steps=1), 2)):
        fa = FedAvg(_model(), get_optimizer("sgd", 1e-2), cfg, local_epochs=epochs, device="cpu")
        runs.append(fa.train(torch.Generator().manual_seed(5), x, y, counts, batch_size=64,
                             rounds=2))
    (pa, ha), (pb, hb) = runs
    assert all(torch.equal(pa[k], pb[k]) for k in pa) and ha == hb


def test_fedavg_scan_matches_loop_bitwise():
    x, y, counts = _fed()
    vx, vy = _val()
    cfg = FLConfig(num_nodes=5, rounds=9, inactive_ratio=0.3)

    def run(engine):
        fa = FedAvg(_model(), get_optimizer("sgd", 1e-2), cfg, device="cpu")
        return fa.train(torch.Generator().manual_seed(7), x, y, counts, batch_size=BATCH,
                        engine=engine, chunk=4, val_data=(vx, vy), eval_every=3)

    (p_loop, h_loop), (p_scan, h_scan) = run("loop"), run("scan")
    assert len(h_loop) == 9 and h_loop == h_scan
    assert len([h for h in h_scan if "val_loss" in h]) == 3
    assert all(torch.equal(p_loop[k], p_scan[k]) for k in p_loop)


def test_early_stop_truncates_and_is_chunk_invariant():
    """The latch: the run stops after ``patience`` non-improving evals,
    the history ends at the tripping round, the result does not depend
    on where the chunks end, and the stopped prefix is the unstopped
    run's."""
    x, y, counts = _fed()
    vx, vy = _val()
    cfg = FLConfig(num_nodes=5, rounds=30, inactive_ratio=0.0)

    def run(chunk, patience=1):
        fa = FedAvg(_model(), get_optimizer("sgd", 1e-2), cfg, device="cpu")
        return fa.train(torch.Generator().manual_seed(7), x, y, counts, batch_size=BATCH,
                        chunk=chunk, val_data=(vx, vy), eval_every=2,
                        early_stop_patience=patience)

    (p_one, h_one), (p_mid, h_mid) = run(30), run(7)
    assert len(h_one) < 30 and "val_loss" in h_one[-1]
    assert [r["round"] for r in h_one] == list(range(len(h_one)))
    assert h_one == h_mid and all(torch.equal(p_one[k], p_mid[k]) for k in p_one)
    _, h_full = run(30, patience=0)
    assert h_full[: len(h_one)] == h_one


def test_stop_latch_ignores_nan_and_trips_once():
    stop = chunked.init_stop("cpu")
    nan = torch.tensor(float("nan"))
    for t, v in enumerate([nan, torch.tensor(1.0), nan, torch.tensor(2.0), torch.tensor(0.5)]):
        stop = chunked.update_stop(stop, v, t, patience=1)
    assert bool(stop.done) and int(stop.stop_round) == 3
    assert float(stop.best_val) == 0.5 and int(stop.bad_evals) == 0
    assert stop.bad_evals.dtype == torch.int32 and stop.stop_round.dtype == torch.int32


def test_engine_guards_and_refusals():
    x, y, counts = _fed()
    fa = FedAvg(_model(), get_optimizer("sgd", 1e-2), FLConfig(num_nodes=5, rounds=2),
                device="cpu")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="engine"):
        fa.train(gen, x, y, counts, engine="while")
    with pytest.raises(ValueError, match="early_stop_patience"):
        fa.train(gen, x, y, counts, early_stop_patience=2)
    meta = MAML(_model(), get_optimizer("adam", 1e-3), device="cpu")
    with pytest.raises(ValueError, match="engine"):
        meta.train(gen, x, y, counts, engine="while")
    with pytest.raises(ValueError, match="early_stop_patience"):
        meta.train(gen, x, y, counts, early_stop_patience=1)
    with pytest.raises(ValueError, match="engine"):
        train_supervised(_model(), get_optimizer("sgd", 1e-2), gen, x[0], y[0], engine="while",
                         device="cpu")
    with pytest.raises(ValueError, match="early_stop_patience"):
        train_supervised(_model(), get_optimizer("sgd", 1e-2), gen, x[0], y[0],
                         early_stop_patience=1, device="cpu")
    loss_fn = lambda p, bx, by: 0.0  # noqa: E731
    for make in (lambda: FedAvg(_model(), get_optimizer("sgd", 1e-2), FLConfig(),
                                loss_fn=loss_fn, device="cpu"),
                 lambda: MetaSGD(_model(), get_optimizer("adam", 1e-3), loss_fn=loss_fn,
                                 device="cpu"),
                 lambda: train_supervised(_model(), get_optimizer("sgd", 1e-2), gen, x[0], y[0],
                                          loss_fn=loss_fn, device="cpu")):
        with pytest.raises(NotImplementedError, match="loss_fn"):
            make()


# ---------------------------------------------------------- MAML/MetaSGD

# the meta-optimizer: Adam as the paper's runs; SGD at a large rate, so
# the params move by the meta-gradient itself, which a first-order
# (no ``create_graph``) inner loop misses by > 1e-2 here
META_OPTS = [("adam", 1e-3), ("sgd", 0.5)]


@pytest.mark.parametrize("opt,lr", META_OPTS, ids=[o for o, _ in META_OPTS])
@pytest.mark.parametrize("jcls,cls", [(JaxMAML, MAML), (JaxMetaSGD, MetaSGD)],
                         ids=["maml", "metasgd"])
def test_meta_two_steps_match_jax(jcls, cls, opt, lr):
    x, y, counts = _fed(n=4, m=24)
    key = jax.random.PRNGKey(3)
    kw = dict(inner_lr=5e-2, inner_steps=2)
    jp, jlrs, jhist = jcls(JaxLSTM(hidden=H).as_model(), jax_get_optimizer(opt, lr),
                           **kw).train(key, x, y, counts, batch_size=BATCH, steps=2,
                                       engine="loop")
    k_init, draws = jax_meta_draws(key, counts, 2, 2)
    meta = cls(_model(), get_optimizer(opt, lr), device="cpu", **kw)
    params, lrs, hist = meta.train(None, x, y, counts, batch_size=BATCH, steps=2,
                                   params=params_from_numpy(_jax_params(k_init), "cpu"),
                                   draws=draws)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_vec(params), _vec(jp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_vec(lrs), _vec(jlrs), rtol=0, atol=1e-5)
    moved = not np.allclose(_vec(lrs), np.float32(5e-2))
    assert moved == (cls is MetaSGD)


def test_metasgd_learns_inner_lrs_and_diverges_from_maml():
    x, y, counts = _fed(n=3, m=16)
    runs = [cls(_model(), get_optimizer("adam", 1e-2), inner_lr=0.05, inner_steps=2,
                device="cpu").train(torch.Generator().manual_seed(2), x, y, counts,
                                    batch_size=BATCH, steps=3)
            for cls in (MAML, MetaSGD)]
    (p_a, lrs_a, _), (p_b, lrs_b, _) = runs
    assert np.all(_vec(lrs_a) == np.float32(0.05))
    assert not np.allclose(_vec(lrs_b), 0.05)
    assert not np.allclose(_vec(p_a), _vec(p_b))


@pytest.mark.parametrize("cls", [MAML, MetaSGD], ids=["maml", "metasgd"])
def test_meta_scan_matches_loop_bitwise(cls):
    x, y, counts = _fed(n=4, m=30)
    vx, vy = _val()

    def run(engine):
        meta = cls(_model(), get_optimizer("adam", 1e-3), inner_lr=1e-2, inner_steps=2,
                   device="cpu")
        return meta.train(torch.Generator().manual_seed(3), x, y, counts, batch_size=BATCH,
                          steps=7, engine=engine, chunk=3, val_data=(vx, vy), eval_every=2)

    (p_loop, lr_loop, h_loop), (p_scan, lr_scan, h_scan) = run("loop"), run("scan")
    assert h_loop == h_scan and len([h for h in h_scan if "val_loss" in h]) == 3
    assert all(torch.equal(p_loop[k], p_scan[k]) for k in p_loop)
    assert all(torch.equal(lr_loop[k], lr_scan[k]) for k in lr_loop)


# ------------------------------------------------------------ supervised

@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_supervised_twenty_steps_match_jax(opt):
    x, y, _ = _fed(n=1, m=120)
    x, y = x[0], y[0]
    vx, vy = _val()
    key = jax.random.PRNGKey(5)
    kw = dict(batch_size=BATCH, steps=20, val=(vx, vy), eval_every=5)
    jp, jhist = jax_train_supervised(JaxLSTM(hidden=H).as_model(),
                                     jax_get_optimizer(opt, LR[opt]), key, x, y,
                                     engine="loop", **kw)
    k_init, draws = jax_supervised_draws(key, len(x), 20)
    params, hist = train_supervised(_model(), get_optimizer(opt, LR[opt]), None, x, y,
                                    params=params_from_numpy(_jax_params(k_init), "cpu"),
                                    draws=draws, device="cpu", **kw)
    assert [sorted(h) for h in hist] == [sorted(h) for h in jhist]
    (losses, vals), (jlosses, jvals) = _losses(hist), _losses(jhist)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    np.testing.assert_allclose([v for _, v in vals], [v for _, v in jvals], rtol=0, atol=1e-5)
    _close(_vec(params), _vec(jp), opt)


def test_supervised_returns_best_val_params_not_last():
    """An anti-correlated val set: as training fits y, the val targets
    -y get worse every eval, so the best-val checkpoint is the first
    boundary, never the last."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6).astype(np.float32)).astype(np.float32)
    model = LSTMModel(history_len=6, hidden=H).as_model()
    params, history = train_supervised(model, get_optimizer("sgd", 5e-2),
                                       torch.Generator().manual_seed(0), x, y, batch_size=16,
                                       steps=40, val=(x, -y), eval_every=10, device="cpu")
    vals = [h["val_loss"] for h in history if "val_loss" in h]
    assert len(vals) == 4
    pred = model.apply(params, torch.from_numpy(x))
    returned = float(torch.mean(torch.square(pred - torch.from_numpy(-y))))
    assert returned == pytest.approx(min(vals), rel=1e-5)
    assert returned < vals[-1], (returned, vals)


def test_supervised_scan_matches_loop_bitwise():
    x, y, _ = _fed(n=1, m=120)
    x, y = x[0], y[0]
    vx, vy = _val()

    def run(engine, **kw):
        return train_supervised(_model(), get_optimizer("sgd", 1e-2),
                                torch.Generator().manual_seed(5), x, y, batch_size=BATCH,
                                engine=engine, device="cpu", **kw)

    p_loop, h_loop = run("loop", steps=23, val=(vx, vy), eval_every=5)
    p_scan, h_scan = run("scan", steps=23, val=(vx, vy), eval_every=5, chunk=7)
    assert h_loop == h_scan and len([h for h in h_scan if "val_loss" in h]) == 4
    assert all(torch.equal(p_loop[k], p_scan[k]) for k in p_loop)
    # without val both engines return the final params
    (pa, ha), (pb, hb) = run("scan", steps=9), run("loop", steps=9)
    assert all(torch.equal(pa[k], pb[k]) for k in pa) and ha == hb and len(ha) == 9


# ------------------------------------------------------------- the draws

def test_production_draws_shapes_ranges_and_seeding():
    counts = torch.tensor([5, 1, 0, 300])
    hi = counts.clamp_min(1)
    m = draw_meta(torch.Generator().manual_seed(3), counts, inner_steps=3, batch_size=500)
    assert m.support.shape == (4, 3, 500) and m.query.shape == (4, 500)
    assert bool((m.query < hi[:, None]).all()) and bool((m.support < hi[:, None, None]).all())
    assert set(m.query[0].tolist()) == set(range(5))
    s = draw_supervised(torch.Generator().manual_seed(3), 7, 500)
    assert s.shape == (500,) and s.dtype == torch.int64 and set(s.tolist()) == set(range(7))
    again = draw_meta(torch.Generator().manual_seed(3), counts, inner_steps=3, batch_size=500)
    assert torch.equal(m.support, again.support) and torch.equal(m.query, again.query)


def test_trainers_need_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, y, _ = _fed(n=1)
    for make in (lambda: FedAvg(_model(), get_optimizer("sgd", 1e-2), FLConfig()),
                 lambda: MAML(_model(), get_optimizer("adam", 1e-3)),
                 lambda: train_supervised(_model(), get_optimizer("sgd", 1e-2),
                                          torch.Generator(), x[0], y[0], steps=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ------------------------------------------ loop ignores early stopping

def _anti_val(x, y):
    """Val windows whose targets are the negated training targets: as a
    run fits y, every eval gets worse, so patience 1 trips at once."""
    return x.reshape(-1, L)[:32], -y.reshape(-1)[:32]


def _assert_scan_stops(run_scan, total):
    """The guard against a vacuous check: with the same draws the scan
    engine does stop early here, so the loop's full history is the
    engine's doing and not the data's."""
    assert len(run_scan()) < total


def test_fedavg_loop_trains_every_round_as_jax_loop():
    x, y, counts = _fed()
    val = _anti_val(x, y)
    rounds, cfg = 6, dict(num_nodes=5, rounds=6, inactive_ratio=0.3, local_steps=2)
    kw = dict(batch_size=BATCH, val_data=val, eval_every=1, early_stop_patience=1)
    key = jax.random.PRNGKey(11)
    jp, jhist = JaxFedAvg(JaxLSTM(hidden=H).as_model(), jax_get_optimizer("sgd", LR["sgd"]),
                          JaxFLConfig(**cfg)).train(key, x, y, counts, engine="loop", **kw)
    k_init, draws = jax_fedavg_draws(key, counts, rounds, 2)

    def run(engine):
        fa = FedAvg(_model(), get_optimizer("sgd", LR["sgd"]), FLConfig(**cfg), device="cpu")
        return fa.train(None, x, y, counts, engine=engine, draws=draws,
                        params=params_from_numpy(_jax_params(k_init), "cpu"), **kw)

    params, hist = run("loop")
    assert len(jhist) == rounds and [h["round"] for h in hist] == list(range(rounds))
    (losses, vals), (jlosses, jvals) = _losses(hist), _losses(jhist)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    np.testing.assert_allclose([v for _, v in vals], [v for _, v in jvals], rtol=0, atol=1e-5)
    _close(_vec(params), _vec(jp), "sgd")
    _assert_scan_stops(lambda: run("scan")[1], rounds)


def test_maml_loop_trains_every_step_as_jax_loop():
    x, y, counts = _fed(n=4, m=24)
    val = _anti_val(x, y)
    steps, opt = 6, META_OPTS[0]
    kw = dict(batch_size=BATCH, steps=steps, val_data=val, eval_every=1, early_stop_patience=1)
    mkw = dict(inner_lr=5e-2, inner_steps=2)
    key = jax.random.PRNGKey(3)
    jp, jlrs, jhist = JaxMAML(JaxLSTM(hidden=H).as_model(), jax_get_optimizer(*opt),
                              **mkw).train(key, x, y, counts, engine="loop", **kw)
    k_init, draws = jax_meta_draws(key, counts, steps, 2)

    def run(engine):
        meta = MAML(_model(), get_optimizer(*opt), device="cpu", **mkw)
        return meta.train(None, x, y, counts, engine=engine, draws=draws,
                          params=params_from_numpy(_jax_params(k_init), "cpu"), **kw)

    params, _, hist = run("loop")
    assert len(jhist) == steps and [h["round"] for h in hist] == list(range(steps))
    (losses, vals), (jlosses, jvals) = _losses(hist), _losses(jhist)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    np.testing.assert_allclose([v for _, v in vals], [v for _, v in jvals], rtol=0, atol=1e-5)
    np.testing.assert_allclose(_vec(params), _vec(jp), rtol=0, atol=1e-5)
    _assert_scan_stops(lambda: run("scan")[2], steps)


def test_supervised_loop_trains_every_step_as_jax_loop():
    """Every step runs and the best-val checkpoint comes back, as JAX's
    loop returns it (here the first eval's params)."""
    x, y, _ = _fed(n=1, m=120)
    x, y = x[0], y[0]
    steps = 12
    kw = dict(batch_size=BATCH, steps=steps, val=_anti_val(x, y), eval_every=1,
              early_stop_patience=1)
    key = jax.random.PRNGKey(5)
    jp, jhist = jax_train_supervised(JaxLSTM(hidden=H).as_model(),
                                     jax_get_optimizer("sgd", LR["sgd"]), key, x, y,
                                     engine="loop", **kw)
    k_init, draws = jax_supervised_draws(key, len(x), steps)

    def run(engine):
        return train_supervised(_model(), get_optimizer("sgd", LR["sgd"]), None, x, y,
                                engine=engine, draws=draws, device="cpu",
                                params=params_from_numpy(_jax_params(k_init), "cpu"), **kw)

    params, hist = run("loop")
    assert len(jhist) == steps and [h["step"] for h in hist] == list(range(steps))
    (losses, vals), (jlosses, jvals) = _losses(hist), _losses(jhist)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    np.testing.assert_allclose([v for _, v in vals], [v for _, v in jvals], rtol=0, atol=1e-5)
    _close(_vec(params), _vec(jp), "sgd")
    _assert_scan_stops(lambda: run("scan")[1], steps)
