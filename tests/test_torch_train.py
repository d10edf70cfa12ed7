"""The port's trainer and training CLI against the JAX package.

One ``GluADFL.round`` of the port against ``repro.core.GluADFL._round``
from the same state and the same draws: the JAX trainer's key chain is
split here in ``_round``'s order (``split(key, 4)`` -> activity,
topology, batches; the DP split; ``split(k_batch, N)`` and
``split(node_key, local_steps)`` for the batch indices; one noise key
per leaf for DP) and the draws are handed to the port as a
``RoundDraws``.  Then five rounds of ``train`` against
``GluADFL.train`` with the history records, the loss's gradient against
``jax.grad``, the metrics and config copies, and the CLI, whose
checkpoint the JAX package's ``load_population`` reads back.

Tolerances, all on fp32 values of magnitude ~1:
  * one round with SGD: params and loss within ``atol=1e-6``; they
    differ by the summation order of the gradient (autograd of batched
    matmuls against ``jax.grad`` of a ``vmap``), scaled by lr=1e-2, and
    of the gossip contraction (a few ulps);
  * one round with Adam (lr=1e-3): within ``atol=1e-6`` except where a
    gradient element is near the roundoff of its own terms: there
    ``mhat / (sqrt(vhat) + eps)`` amplifies the difference, up to a
    sign flip that moves the element by 2·lr.  So: 99.9% of the
    elements within 1e-6 and all within 2·lr;
  * five rounds with SGD: params within ``atol=1e-5``, losses and val
    RMSE within ``atol=2e-6`` (roundoff compounds over rounds);
  * five rounds with Adam: the losses within ``atol=1e-4`` and the
    params within a relative norm of ``1e-3``;
  * staleness, the optimizer's int32 ``step``, and inactive rows:
    bitwise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JaxFLConfig
from repro.config import apply_overrides as jax_apply_overrides
from repro.config import ExperimentConfig as JaxExperimentConfig
from repro.core import GluADFL as JaxGluADFL
from repro.metrics import all_metrics as jax_all_metrics
from repro.models import LSTMModel as JaxLSTM
from repro.optim import get_optimizer as jax_get_optimizer
from repro.serve.servable import load_population as jax_load_population
from repro_torch.config import ExperimentConfig, FLConfig, apply_overrides
from repro_torch.core import GluADFL
from repro_torch.core.gluadfl import mse_value_and_grad
from repro_torch.launch import train as train_cli
from repro_torch.metrics import all_metrics
from repro_torch.models import LSTMModel
from repro_torch.optim import get_optimizer
from repro_torch.serve import load_population
from repro_torch.utils.rng import RoundDraws

H = 8
BATCH = 8
LR = {"sgd": 1e-2, "adam": 1e-3}


def _data(n, seed=0, m=48, steps=12):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m, steps)).astype(np.float32)
    y = (x[:, :, -1] * 0.8 + 0.1 * rng.normal(size=(n, m))).astype(np.float32)
    counts = rng.integers(min(10, m), m + 1, size=n).astype(np.int32)
    return x, y, counts


def _flat(tree, n):
    return np.concatenate([np.asarray(tree[k]).reshape(n, -1) for k in sorted(tree)], axis=1)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _batch_idx(k_batch, counts, local_steps, batch):
    """(N, local_steps, batch) indices, as ``_round`` draws them:
    ``split(k_batch, N)``, then ``split(node_key, local_steps)``, then
    ``randint(k, (batch,), 0, max(count, 1))``."""
    def node(node_key, c):
        return jax.vmap(lambda k: jax.random.randint(k, (batch,), 0, jnp.maximum(c, 1)))(
            jax.random.split(node_key, local_steps))
    return jax.vmap(node)(jax.random.split(k_batch, counts.shape[0]), counts)


def jax_draws(key, n, counts, *, local_steps=1, batch=BATCH, random_topology, dp_like=None):
    """The draws ``GluADFL._round`` makes from ``key``, in its split
    order; returns ``(next_key, RoundDraws)``."""
    key, k_act, k_top, k_batch = jax.random.split(key, 4)
    u = np.asarray(jax.random.uniform(k_act, (n,)))
    scores = np.asarray(jax.random.uniform(k_top, (n, n))) if random_topology else None
    noise = None
    if dp_like is not None:
        key, k_dp = jax.random.split(key)
        leaves = jax.tree.leaves(dp_like)
        keys = jax.random.split(k_dp, len(leaves))
        noise = np.concatenate([np.asarray(jax.random.normal(k, l.shape, l.dtype)).reshape(n, -1)
                                for k, l in zip(keys, leaves)], axis=1)
    idx = np.asarray(_batch_idx(k_batch, jnp.asarray(counts, jnp.int32), local_steps,
                                batch)).astype(np.int64)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    return key, RoundDraws(t(u), t(scores), torch.from_numpy(idx), t(noise))


def _pair(n, opt, fl=None, **knobs):
    fl = {"num_nodes": n, "comm_batch": 7, "inactive_ratio": 0.5, **(fl or {})}
    jt = JaxGluADFL(JaxLSTM(hidden=H).as_model(), jax_get_optimizer(opt, LR[opt]),
                    JaxFLConfig(**fl), **knobs)
    tt = GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer(opt, LR[opt]), FLConfig(**fl),
                 device="cpu", **knobs)
    return jt, tt


# ----------------------------------------------------------- one round

ROUND_CASES = [
    # (n, topology, mixer, repr, dp sigma, grad_at, optimizer, extra FLConfig)
    (6, "random", "tree", "dense", 0.0, "premix", "sgd", {}),
    (6, "random", "tree", "dense", 0.01, "mixed", "sgd", {}),
    (40, "random", "tree", "sparse", 0.0, "mixed", "sgd", {}),
    (40, "ring", "tree", "sparse", 0.01, "premix", "sgd", {}),
    (6, "random", "kernel", "dense", 0.0, "premix", "sgd", {}),
    (6, "cluster", "kernel", "dense", 0.01, "mixed", "sgd", {}),
    (40, "ring", "kernel", "sparse", 0.0, "premix", "sgd", {}),
    (40, "random", "kernel", "sparse", 0.01, "mixed", "sgd", {}),
    (6, "random", "tree", "dense", 0.0, "premix", "sgd",
     dict(schedule="markov", data_skew=0.5, local_steps=2)),
    (40, "random", "kernel", "sparse", 0.01, "premix", "adam", {}),
]


@pytest.mark.parametrize("n,topo,mixer,repr_,sigma,grad_at,opt,fl", ROUND_CASES,
                         ids=[f"{c[2]}-{c[3]}-N{c[0]}-{c[1]}-dp{c[4]}-{c[5]}-{c[6]}"
                              + ("-markov-skew-2steps" if c[7] else "") for c in ROUND_CASES])
def test_one_round_matches_jax(n, topo, mixer, repr_, sigma, grad_at, opt, fl):
    x, y, counts = _data(n, seed=n)
    jt, tt = _pair(n, opt, dict(topology=topo, **fl), mixer=mixer, gossip_repr=repr_,
                   dp_noise_sigma=sigma, grad_at=grad_at)
    js = jt.init(jax.random.PRNGKey(n))
    if fl.get("schedule") == "markov":
        # a carried-over staleness, so the chain's previous state matters
        js = dataclasses.replace(js, staleness=jnp.asarray((np.arange(n) % 3).astype(np.float32)))
    js2, jloss = jt._round_jit(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(counts),
                               batch_size=BATCH)
    ts = tt.state_from_params({k: np.asarray(v) for k, v in js.params.items()})
    ts.staleness = torch.from_numpy(np.array(js.staleness))
    _, draws = jax_draws(js.key, n, counts, local_steps=tt.cfg.local_steps,
                         random_topology=topo == "random", dp_like=js.params if sigma else None)
    ts2, loss = tt.round(ts, tt.to_device(x, y, counts), draws)

    want = _flat(js2.params, n)
    got = ts2.params.numpy()
    diff = np.abs(got - want)
    if opt == "sgd":
        assert diff.max() <= 1e-6, diff.max()
    else:
        assert np.mean(diff <= 1e-6) >= 0.999 and diff.max() <= 2 * LR[opt], diff.max()
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts2.staleness.numpy(), np.asarray(js2.staleness))
    np.testing.assert_array_equal(ts2.opt_state["step"].numpy(), np.asarray(js2.opt_state["step"]))
    assert ts2.opt_state["step"].dtype == torch.int32 and ts2.round == 1
    inactive = np.asarray(js2.staleness) > 0
    assert inactive.any()
    np.testing.assert_array_equal(got[inactive], ts.params.numpy()[inactive])


# -------------------------------------------------------------- training


def _chain_draws(key, n, counts, rounds, random_topology):
    for _ in range(rounds):
        key, draws = jax_draws(key, n, counts, random_topology=random_topology)
        yield draws


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_five_rounds_of_train_match_jax(opt):
    n, rounds = 40, 5
    x, y, counts = _data(n, seed=3)
    val_x, val_y = (a[:2].reshape(-1, *a.shape[2:]) for a in (x, y))
    jt, tt = _pair(n, opt, dict(topology="random"), mixer="tree", gossip_repr="sparse")
    key = jax.random.PRNGKey(5)
    jpop, jhist, jstate = jt.train(key, x, y, counts, batch_size=BATCH, rounds=rounds,
                                   eval_every=2, val_data=(val_x, val_y))
    init = jt.init(key)
    state = tt.state_from_params({k: np.asarray(v) for k, v in init.params.items()})
    draws = _chain_draws(init.key, n, counts, rounds, random_topology=True)
    pop, hist, tstate = tt.train(None, x, y, counts, batch_size=BATCH, rounds=rounds,
                                 eval_every=2, val_data=(val_x, val_y), chunk=2,
                                 state=state, draws=draws)
    assert [sorted(h) for h in hist] == [sorted(h) for h in jhist]
    assert [h["round"] for h in hist] == list(range(rounds))
    losses = np.array([h["loss"] for h in hist])
    jlosses = np.array([h["loss"] for h in jhist])
    got, want = tstate.params.numpy(), _flat(jstate.params, n)
    if opt == "sgd":
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=2e-6)
        np.testing.assert_allclose([h["val_rmse"] for h in hist if "val_rmse" in h],
                                   [h["val_rmse"] for h in jhist if "val_rmse" in h],
                                   rtol=0, atol=2e-6)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(_flat({k: v[None] for k, v in pop.items()}, 1),
                                   _flat({k: np.asarray(v)[None] for k, v in jpop.items()}, 1),
                                   rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    np.testing.assert_array_equal(tstate.staleness.numpy(), np.asarray(jstate.staleness))


def test_scan_and_loop_engines_give_the_same_history():
    """The history and the params do not depend on how many rounds
    pass between host syncs: ``chunk=1`` (the JAX package's loop
    engine, the CLI's ``--engine loop`` / ``--chunk 0``), 3 and the
    default."""
    n = 6
    x, y, counts = _data(n, seed=4)
    _, tt = _pair(n, "sgd", dict(topology="ring"), mixer="kernel")
    runs = []
    for chunk in (3, 1, None):
        pop, hist, state = tt.train(torch.Generator().manual_seed(0), x, y, counts,
                                    batch_size=BATCH, rounds=7, eval_every=3,
                                    val_data=(x[0], y[0]), chunk=chunk)
        runs.append((hist, state.params))
    for hist, params in runs[1:]:
        assert hist == runs[0][0]
        assert torch.equal(params, runs[0][1])
    assert [h["round"] for h in runs[0][0] if "val_rmse" in h] == [2, 5]


def test_training_draws_from_the_generator_and_learns():
    n = 6
    x, y, counts = _data(n, seed=6)
    _, tt = _pair(n, "adam", dict(topology="random", inactive_ratio=0.3), mixer="kernel")
    tt.optimizer = get_optimizer("adam", 1e-2)
    _, hist, _ = tt.train(torch.Generator().manual_seed(1), x, y, counts, batch_size=16, rounds=40)
    first = np.mean([h["loss"] for h in hist[:10]])
    last = np.mean([h["loss"] for h in hist[-10:]])
    assert np.isfinite(last) and last < first
    _, again, _ = tt.train(torch.Generator().manual_seed(1), x, y, counts, batch_size=16, rounds=40)
    assert again == hist


def test_draw_round_shapes_ranges_and_seeding():
    """Production draws: uniforms in [0, 1), batch indices inside each
    node's true window count (1 for an empty node, as JAX's
    ``randint(.., 0, max(count, 1))``), noise only when asked for, and
    the same record from the same seed."""
    from repro_torch.utils.rng import draw_round

    counts = torch.tensor([5, 1, 0, 300])
    a = draw_round(torch.Generator().manual_seed(3), counts, local_steps=2, batch_size=500,
                   random_topology=True, dp_dim=7)
    assert a.u_act.shape == (4,) and a.scores.shape == (4, 4) and a.dp_noise.shape == (4, 7)
    assert bool(((a.u_act >= 0) & (a.u_act < 1)).all())
    assert a.batch_idx.shape == (4, 2, 500) and a.batch_idx.dtype == torch.int64
    hi = counts.clamp_min(1)[:, None, None]
    assert bool(((a.batch_idx >= 0) & (a.batch_idx < hi)).all())
    assert set(a.batch_idx[0].unique().tolist()) == set(range(5))
    b = draw_round(torch.Generator().manual_seed(3), counts, local_steps=2, batch_size=500,
                   random_topology=True, dp_dim=7)
    assert all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("u_act", "scores", "batch_idx", "dp_noise"))
    c = draw_round(torch.Generator().manual_seed(3), counts, local_steps=1, batch_size=4,
                   random_topology=False)
    assert c.scores is None and c.dp_noise is None


# ------------------------------------------------------ the model's loss


def test_loss_and_grads_match_jax_grad():
    """The trainer's per-node loss and gradient (``mse_value_and_grad``
    through ``LSTMModel.apply_nodes``) against ``jax.value_and_grad`` of
    the JAX model's MSE, node by node (atol 1e-6: fp32 summation order)."""
    n = 3
    x, y, _ = _data(n, seed=7, m=BATCH)
    jm = JaxLSTM(hidden=H)
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    rows = [jm.init(k) for k in keys]
    stacked = {k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}
    _, tt = _pair(n, "sgd")
    state = tt.state_from_params(stacked)
    losses, grads = mse_value_and_grad(tt.model, tt.layout, state.params, torch.from_numpy(x),
                                       torch.from_numpy(y))
    assert not grads.requires_grad and grads.shape == state.params.shape

    def loss_fn(p, bx, by):
        return jnp.mean(jnp.square(jm.apply(p, bx) - by))

    for i in range(n):
        jl, jg = jax.value_and_grad(loss_fn)(rows[i], jnp.asarray(x[i]), jnp.asarray(y[i]))
        np.testing.assert_allclose(float(losses[i]), float(jl), rtol=0, atol=1e-6)
        np.testing.assert_allclose(grads[i].numpy(), _flat({k: v[None] for k, v in jg.items()}, 1)[0],
                                   rtol=0, atol=1e-6)


# -------------------------------------------------- metrics and configs


def test_metrics_match_jax_bitwise():
    rng = np.random.default_rng(8)
    yt = rng.uniform(40, 300, size=500)
    yp = yt + rng.normal(scale=20, size=500)
    assert all_metrics(yt, yp) == jax_all_metrics(yt, yp)
    assert all_metrics(yt[:5], yp[:5]) == jax_all_metrics(yt[:5], yp[:5])


def test_config_overrides_match_jax():
    ov = ["fl.comm_batch=3", "fl.inactive_ratio=0.25", "train.lr=0.01", "train.optimizer=sgd",
          "data.dataset=replace-bg", "fl.schedule=markov"]
    got = dataclasses.asdict(apply_overrides(ExperimentConfig(), ov))
    want = dataclasses.asdict(jax_apply_overrides(JaxExperimentConfig(), ov))
    assert got == want
    with pytest.raises(KeyError):
        apply_overrides(ExperimentConfig(), ["fl.nope=1"])


# ------------------------------------------------------------------ CLI


def test_cli_checkpoint_loads_in_both_packages(tmp_path, capsys):
    rc = train_cli.main(["--device", "cpu", "--fast-data", "--rounds", "2", "--hidden", "8",
                         "--mixer", "kernel", "--eval-every", "1", "--out", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "gossip-repr auto -> dense" in out and "population:" in out
    ckpt = tmp_path / "gluadfl_ohiot1dm_random.npz"
    jmodel, jpop = jax_load_population(ckpt)
    model, pop = load_population(ckpt)
    np.testing.assert_array_equal(_flat({k: v[None] for k, v in pop.items()}, 1),
                                  _flat({k: np.asarray(v)[None] for k, v in jpop.items()}, 1))
    xs = np.random.default_rng(9).normal(size=(4, 12)).astype(np.float32)
    np.testing.assert_allclose(model.apply(pop, torch.from_numpy(xs)).numpy(),
                               np.asarray(jmodel.apply(jpop, jnp.asarray(xs))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("argv,chunk", [([], None), (["--chunk", "5"], 5), (["--chunk", "0"], 1),
                                        (["--engine", "loop"], 1)])
def test_cli_engine_and_chunk_flags_set_the_sync_interval(argv, chunk, monkeypatch):
    """``--engine loop`` and ``--chunk 0`` both mean a host sync every
    round (``chunk=1``); no flag leaves the trainer's default."""
    seen = {}

    class Stop(Exception):
        pass

    def fake_train(self, *args, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(GluADFL, "train", fake_train)
    with pytest.raises(Stop):
        train_cli.run(["--device", "cpu", "--fast-data", "--hidden", "8", *argv])
    assert seen["chunk"] == chunk


@pytest.mark.parametrize("argv", [["--coordinator", "localhost:1234"], ["--num-processes=2"],
                                  ["--use-kernel"], ["--mixer", "sharded"],
                                  ["--gossip-impl", "psum"], ["--gossip-impl", "gather"]])
def test_cli_refuses_what_is_not_ported(argv, capsys):
    assert train_cli.main(["--device", "cpu", *argv]) == 2
    assert "not ported" in capsys.readouterr().err


def test_cli_gossip_impl_masked_trains_bitwise_like_allgather(tmp_path, capsys):
    """``--gossip-impl masked`` draws its masks apart from the round's
    draws and cancels them exactly: the same history and the same
    checkpoint, bit for bit, as ``allgather``."""
    runs = {}
    for impl in ("allgather", "masked", "auto"):
        runs[impl] = train_cli.run(["--device", "cpu", "--fast-data", "--rounds", "3", "--hidden",
                                    "8", "--gossip-impl", impl, "--out", str(tmp_path / impl)])
        out = capsys.readouterr().out
        assert f"gossip-impl {'allgather' if impl == 'auto' else impl}" in out
    assert "gossip-impl auto -> allgather" in out
    assert runs["masked"].trainer.plan.masked
    for impl in ("masked", "auto"):
        assert runs[impl].history == runs["allgather"].history
        a, b = (np.load(runs[k].checkpoint)["vec"] for k in ("allgather", impl))
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("flag", train_cli.NOT_PORTED_FLAGS)
def test_cli_refusal_names_only_what_is_refused(flag, capsys):
    """The refusal names the flag and the paths it belongs to (multi-host,
    the deprecated ``--use-kernel``), and no path that is ported."""
    assert train_cli.main(["--device", "cpu", flag]) == 2
    err = capsys.readouterr().err
    assert (f"{flag} is not ported to PyTorch yet "
            "(multi-host runs and the deprecated --use-kernel; use --mixer kernel)") in err
    assert "sweep" not in err


def test_no_gpu_means_cpu_must_be_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer("sgd", 0.1), FLConfig())
