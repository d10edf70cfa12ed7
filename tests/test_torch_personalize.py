"""The port's cold-start personalization against ``repro.core.personalize``.

The minibatch indices are drawn with ``jax.random`` in the JAX
fine-tune's order (per patient key: ``k, sub = split(k)`` each step,
then ``randint(sub, (bs,), 0, max(min(count, M), 1))``) and handed to
the port, so both packages take the same steps on the same windows.
Then the six engine pins of ``tests/test_personalize.py`` on the port
alone, the production draws, and the servable's forecasts after a
cohort's fine-tune against the JAX servable's.

Tolerances, on fp32 values of magnitude ~1, as in
``tests/test_torch_train.py``'s header: the packages differ in the
summation order of the gradient (autograd of batched matmuls against
``jax.grad``), scaled by the learning rate and compounded over steps.
  * SGD (lr 1e-2): params within ``atol=1e-5``, losses within 2e-6;
  * Adam: losses within ``atol=1e-4`` and params within a relative norm
    of 1e-3, since ``mhat / (sqrt(vhat) + eps)`` amplifies the roundoff
    of a gradient element near zero up to a sign flip;
  * forecasts of the servables after the fine-tune: ``atol=1e-5``;
  * the port's engines against each other: bitwise.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.core import personalize as jpersonalize
from repro.core.personalize import personalize_batch_fn as jpersonalize_batch_fn
from repro.models import LSTMModel as JaxLSTM
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.core import personalize, personalize_batch, personalize_batch_fn, personalize_loop
from repro_torch.models import LSTMModel, params_from_numpy
from repro_torch.optim import get_optimizer
from repro_torch.serve import GlucoseServable
from repro_torch.utils.rng import clamped_batch, draw_personalize

HIDDEN, L, STEPS = 4, 8, 6
LR = {"sgd": 1e-2, "adam": 5e-4}


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _jax_batch_idx(keys, counts, n_rows, steps, bs):
    def one(key, count):
        hi = jnp.maximum(jnp.minimum(count, n_rows), 1)

        def step(k, _):
            k, sub = jax.random.split(k)
            return k, jax.random.randint(sub, (bs,), 0, hi)

        return jax.lax.scan(step, key, None, length=steps)[1]

    return jax.vmap(one)(keys, counts)


def jax_batch_idx(keys, counts, n_rows, steps, batch_size=32):
    """(P, steps, bs) int64: the indices JAX's fine-tune draws from
    ``keys`` (P, 2)."""
    bs = clamped_batch(batch_size, n_rows)
    idx = _jax_batch_idx(jnp.asarray(keys), jnp.asarray(counts, jnp.int32), n_rows, steps, bs)
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.fixture(scope="module")
def setup():
    jmodel = JaxLSTM(history_len=L, hidden=HIDDEN).as_model()
    jpop = jmodel.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)
    P, M = 3, 12
    x = rng.normal(size=(P, M, L)).astype(np.float32)
    y = rng.normal(size=(P, M)).astype(np.float32)
    counts = np.array([M, 5, 1], np.int32)  # full, short, single-window
    keys = jax.random.split(jax.random.PRNGKey(0), P)
    model = LSTMModel(history_len=L, hidden=HIDDEN).as_model()
    pop = params_from_numpy({k: np.asarray(v) for k, v in jpop.items()}, "cpu")
    idx = jax_batch_idx(keys, counts, M, STEPS)
    return dict(jmodel=jmodel, jpop=jpop, model=model, pop=pop, x=x, y=y, counts=counts,
                keys=keys, idx=idx)


def _flat(params):
    return np.concatenate([np.asarray(params[k]).reshape(-1) for k in sorted(params)])


def _bitwise(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)


def _row(stacked, i):
    return {k: v[i] for k, v in stacked.items()}


# ----------------------------------------------------------- against JAX


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_personalize_matches_jax_per_patient(setup, opt):
    s = setup
    for i in range(3):
        want = jpersonalize(s["jmodel"], jax_get_optimizer(opt, LR[opt]), s["jpop"], s["keys"][i],
                            s["x"][i], s["y"][i], steps=STEPS, count=int(s["counts"][i]))
        got = personalize(s["model"], get_optimizer(opt, LR[opt]), s["pop"], s["idx"][i],
                          s["x"][i], s["y"][i])
        g, w = _flat({k: v.numpy() for k, v in got.items()}), _flat(want)
        if opt == "sgd":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f"patient {i}")
        else:
            assert np.linalg.norm(g - w) <= 1e-3 * np.linalg.norm(w), f"patient {i}"
        # the fine-tune moved the params
        assert not np.array_equal(g, _flat(s["jpop"]))


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_batch_fn_losses_and_params_match_jax(setup, opt):
    s = setup
    jfn = jpersonalize_batch_fn(s["jmodel"], jax_get_optimizer(opt, LR[opt]), steps=STEPS,
                                n_rows=12)
    jparams, jlosses = jfn(s["jpop"], s["keys"], jnp.asarray(s["x"]), jnp.asarray(s["y"]),
                           jnp.asarray(s["counts"]))
    fn = personalize_batch_fn(s["model"], get_optimizer(opt, LR[opt]), steps=STEPS, n_rows=12)
    params, losses = fn(s["pop"], s["idx"], s["x"], s["y"])
    assert losses.shape == (3, STEPS)
    got = np.concatenate([params[k].numpy().reshape(3, -1) for k in sorted(params)], axis=1)
    want = np.concatenate([np.asarray(jparams[k]).reshape(3, -1) for k in sorted(jparams)], axis=1)
    if opt == "sgd":
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0, atol=2e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), rtol=0, atol=1e-4)
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)


# ------------------------------------------------ the engines agree (bitwise)


def test_personalize_is_bitwise_personalize_loop(setup):
    s = setup
    opt = get_optimizer("adam", 5e-4)
    for i in range(3):
        a = personalize(s["model"], opt, s["pop"], s["idx"][i], s["x"][i], s["y"][i])
        b = personalize_loop(s["model"], opt, s["pop"], s["idx"][i], s["x"][i], s["y"][i])
        assert _bitwise(a, b), f"patient {i} (count {s['counts'][i]})"


def test_batched_rows_match_serial_per_patient(setup):
    s = setup
    opt = get_optimizer("adam", 5e-4)
    stacked = personalize_batch(s["model"], opt, s["pop"], s["idx"], s["x"], s["y"])
    for i in range(3):
        serial = personalize(s["model"], opt, s["pop"], s["idx"][i], s["x"][i], s["y"][i])
        assert _bitwise(_row(stacked, i), serial), f"patient {i} (count {s['counts'][i]})"


def test_batch_fn_closure_matches_batch(setup):
    s = setup
    opt = get_optimizer("adam", 5e-4)
    fn = personalize_batch_fn(s["model"], opt, steps=STEPS, n_rows=12)
    params, losses = fn(s["pop"], s["idx"], s["x"], s["y"])
    assert losses.shape == (3, STEPS) and bool(torch.isfinite(losses).all())
    assert _bitwise(params, personalize_batch(s["model"], opt, s["pop"], s["idx"], s["x"], s["y"]))
    with pytest.raises(ValueError, match="built for M=12"):
        fn(s["pop"], s["idx"][:, :2], s["x"], s["y"])
    with pytest.raises(ValueError, match="built for M=12"):
        fn(s["pop"], s["idx"], s["x"][:, :10], s["y"][:, :10])


def test_batch_size_clamped_to_short_history(setup):
    """batch_size > the history's rows draws batches of the history's
    length: bitwise the explicit batch_size=rows run, loop twin too."""
    s = setup
    opt = get_optimizer("adam", 5e-4)
    sx, sy = s["x"][0, :3], s["y"][0, :3]
    big = draw_personalize(torch.Generator().manual_seed(3), [3], 3, STEPS, 32)
    exact = draw_personalize(torch.Generator().manual_seed(3), [3], 3, STEPS, 3)
    assert big.shape == (1, STEPS, 3) and torch.equal(big, exact)
    a = personalize(s["model"], opt, s["pop"], big[0], sx, sy)
    assert _bitwise(a, personalize(s["model"], opt, s["pop"], exact[0], sx, sy))
    assert _bitwise(a, personalize_loop(s["model"], opt, s["pop"], big[0], sx, sy))
    # JAX's fine-tune clamps the same way
    assert jax_batch_idx(s["keys"][:1], [3], 3, STEPS).shape == (1, STEPS, 3)


def test_padding_rows_never_sampled(setup):
    """Rows past ``count`` are padding: NaN there changes nothing."""
    s = setup
    opt = get_optimizer("adam", 5e-4)
    c = int(s["counts"][1])
    idx = draw_personalize(torch.Generator().manual_seed(4), [c], 12, STEPS, 32)[0]
    assert int(idx.max()) < c
    px, py = np.array(s["x"][1]), np.array(s["y"][1])
    px[c:], py[c:] = np.nan, np.nan
    out = personalize(s["model"], opt, s["pop"], idx, px, py)
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    assert _bitwise(out, personalize(s["model"], opt, s["pop"], idx, s["x"][1], s["y"][1]))


def test_fine_tune_actually_learns(setup):
    """On linear-teacher patients the losses end well below the start."""
    s = setup
    rng = np.random.default_rng(7)
    P, M = 2, 12
    x = rng.normal(size=(P, M, L)).astype(np.float32)
    y = (x @ rng.normal(size=(L,)).astype(np.float32)).astype(np.float32)
    fn = personalize_batch_fn(s["model"], get_optimizer("adam", 1e-2), steps=80, n_rows=M)
    idx = draw_personalize(torch.Generator().manual_seed(5), [M, M], M, 80, 32)
    _, losses = fn(s["pop"], idx, x, y)
    losses = losses.numpy()
    assert np.isfinite(losses).all()
    assert (losses[:, -10:].mean(axis=1) < 0.7 * losses[:, :10].mean(axis=1)).all()


def test_draw_personalize_shapes_ranges_and_seeding():
    counts = torch.tensor([5, 1, 0, 300])
    a = draw_personalize(torch.Generator().manual_seed(3), counts, 40, 7, 500)
    assert a.shape == (4, 7, 40) and a.dtype == torch.int64
    hi = torch.tensor([5, 1, 1, 40])[:, None, None]  # clamped to M, at least 1
    assert bool(((a >= 0) & (a < hi)).all())
    assert set(a[3].unique().tolist()) == set(range(40))
    b = draw_personalize(torch.Generator().manual_seed(3), counts.numpy(), 40, 7, 500)
    assert torch.equal(a, b)
    assert draw_personalize(torch.Generator().manual_seed(3), counts, 40, 7, 8).shape == (4, 7, 8)


# ------------------------------------------------------------- the servable


def _cohort(p, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(p, m, 12)).astype(np.float32)
    y = (0.8 * x[:, :, -1] + 0.1 * rng.normal(size=(p, m))).astype(np.float32)
    return x, y, np.array([m, m // 2, 3][:p], np.int32)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_servable_forecasts_after_personalize_match_jax(opt):
    jlstm = JaxLSTM(hidden=8)
    jpop = jlstm.init(jax.random.PRNGKey(2))
    steps = 20
    jsv = jserve.GlucoseServable(jlstm.as_model(), jpop, buckets=(1, 4),
                                 optimizer=jax_get_optimizer(opt, LR[opt]),
                                 personalize_steps=steps)
    sv = GlucoseServable(LSTMModel(hidden=8).as_model(),
                         params_from_numpy({k: np.asarray(v) for k, v in jpop.items()}, "cpu"),
                         buckets=(1, 4), optimizer=get_optimizer(opt, LR[opt]),
                         personalize_steps=steps, device="cpu")
    x, y, counts = _cohort(3, 16, seed=8)
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    jsv.personalize(["a", "b", "c"], keys, x, y, counts)
    params = sv.personalize(["a", "b", "c"], x, y, counts,
                            batch_idx=jax_batch_idx(keys, counts, 16, steps))
    assert sv.num_rows == jsv.num_rows == 4
    assert [sv.row_of(n) for n in "abc"] == [jsv.row_of(n) for n in "abc"] == [1, 2, 3]
    assert sv.personalize_losses.shape == (3, steps)
    assert all(torch.equal(sv.params_rows([1 + i])[k][0], params[k][i])
               for i in range(3) for k in params)
    windows = np.random.default_rng(10).normal(size=(8, 12)).astype(np.float32)
    rows = [0, 1, 2, 3, 3, 2, 1, 0]
    got = sv.forecast_rows(rows, windows).numpy()
    want = np.asarray(jsv.forecast_rows(rows, windows))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # personalized rows forecast differently from the population's
    assert not np.array_equal(got[1:4], got[[0, 0, 0]])


def test_servable_personalize_takes_exactly_one_draw_source():
    lstm = LSTMModel(hidden=8)
    sv = GlucoseServable(lstm.as_model(), lstm.init(torch.Generator().manual_seed(0)),
                         personalize_steps=3, device="cpu")
    x, y, counts = _cohort(2, 6, seed=11)
    idx = draw_personalize(torch.Generator().manual_seed(1), counts, 6, 3, 32)
    with pytest.raises(ValueError, match="exactly one"):
        sv.personalize(["a", "b"], x, y, counts)
    with pytest.raises(ValueError, match="exactly one"):
        sv.personalize(["a", "b"], x, y, counts, generator=torch.Generator(), batch_idx=idx)
    assert sv.num_rows == 1
    # a generator seeded as the draws were gives the same rows
    a = sv.personalize(["a", "b"], x, y, counts, batch_idx=idx)
    b = sv.personalize(["c", "d"], x, y, counts, generator=torch.Generator().manual_seed(1))
    assert _bitwise(a, b) and sv.num_rows == 5
