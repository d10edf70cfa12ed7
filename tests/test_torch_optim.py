"""The port's optimizers and LR schedules against ``repro.optim``.

The JAX optimizers act on one node's param dict and the trainer vmaps
them over the federation; the port's act on the flat ``(N, D)`` buffer
with one state row per node.  Both get the same gradients (numpy, with a
seed) for several consecutive updates, with per-node ``step`` counters
that differ (as after asynchronous rounds).

Tolerance: SGD (with and without momentum) is held bitwise: each update
is the same fp32 multiply-adds on both sides.  Adam and AdamW are held
to ``rtol=1e-6``: the bias corrections use ``pow``, whose last-ulp
rounding may differ between XLA and PyTorch, and the update divides by
``sqrt(vhat) + eps``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizers as joptim
from repro.optim import schedules as jsched
from repro_torch.optim import optimizers, schedules

N = 5
SHAPES = {"a": (3, 4), "b": (4,)}
D = 16


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(N, -1) for k in sorted(tree)], axis=1)


def _tree(flat):
    return {"a": flat[:, :12].reshape(N, 3, 4), "b": flat[:, 12:]}


def _run(name, kw, updates=4, start_steps=None):
    rng = np.random.default_rng(0)
    params = rng.normal(size=(N, D)).astype(np.float32)
    grads = [rng.normal(size=(N, D)).astype(np.float32) for _ in range(updates)]
    jopt = getattr(joptim, name)(**kw)
    topt = getattr(optimizers, name)(**kw)
    jp = {k: jnp.asarray(v) for k, v in _tree(params).items()}
    jst = jax.vmap(jopt.init)(jp)
    tp = torch.from_numpy(params)
    tst = topt.init(tp)
    if start_steps is not None:
        jst["step"] = jnp.asarray(start_steps, jnp.int32)
        tst["step"] = torch.tensor(start_steps, dtype=torch.int32)
    out = []
    for g in grads:
        jp, jst = jax.vmap(jopt.update)({k: jnp.asarray(v) for k, v in _tree(g).items()}, jst, jp)
        tp, tst = topt.update(torch.from_numpy(g), tst, tp)
        out.append((_flat(jp), tp.numpy(), jst, tst))
    return out


@pytest.mark.parametrize("kw", [dict(lr=0.05), dict(lr=0.05, momentum=0.9)])
def test_sgd_matches_jax_bitwise(kw):
    for jp, tp, jst, tst in _run("sgd", kw):
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tst["step"].numpy(), np.asarray(jst["step"]))
        assert tst["step"].dtype == torch.int32
        if kw.get("momentum"):
            np.testing.assert_array_equal(tst["mu"].numpy(), _flat(jst["mu"]))


@pytest.mark.parametrize("name,kw", [("adam", dict(lr=1e-3)), ("adam", dict(lr=1e-2, b1=0.8)),
                                     ("adamw", dict(lr=1e-3, weight_decay=0.1))])
@pytest.mark.parametrize("start", [None, [0, 3, 10, 100, 1000]])
def test_adam_matches_jax(name, kw, start):
    for jp, tp, jst, tst in _run(name, kw, start_steps=start):
        np.testing.assert_allclose(tp, jp, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tst["m"].numpy(), _flat(jst["m"]), rtol=1e-6, atol=0)
        np.testing.assert_allclose(tst["v"].numpy(), _flat(jst["v"]), rtol=1e-6, atol=0)
        np.testing.assert_array_equal(tst["step"].numpy(), np.asarray(jst["step"]))


def test_get_optimizer_names():
    for name in ("sgd", "adam", "adamw"):
        assert isinstance(optimizers.get_optimizer(name, 1e-3), optimizers.Optimizer)
    with pytest.raises(KeyError):
        optimizers.get_optimizer("lion", 1e-3)


@pytest.mark.parametrize("make", [
    lambda m: m.constant(3e-3),
    lambda m: m.cosine_decay(1e-2, 50, alpha=0.1),
    lambda m: m.warmup_cosine(1e-2, 10, 60),
])
def test_schedules_match_jax(make):
    steps = np.array([0, 1, 5, 10, 11, 30, 59, 60, 200], np.int32)
    want = np.asarray(make(jsched)(jnp.asarray(steps)))
    got = make(schedules)(torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, np.broadcast_to(want, got.shape), rtol=1e-6, atol=1e-9)


def test_scheduled_sgd_uses_each_nodes_step():
    """A schedule sees each node's own step (nodes idle in different
    rounds), as under the JAX trainer's vmap."""
    kw = dict(lr=jsched.cosine_decay(0.1, 8))
    rng = np.random.default_rng(1)
    params = rng.normal(size=(N, D)).astype(np.float32)
    g = rng.normal(size=(N, D)).astype(np.float32)
    steps = np.array([0, 2, 4, 6, 8], np.int32)
    jopt = joptim.sgd(**kw)
    jp = {k: jnp.asarray(v) for k, v in _tree(params).items()}
    jst = {"step": jnp.asarray(steps), "mu": None}
    jp, _ = jax.vmap(jopt.update, in_axes=(0, {"step": 0, "mu": None}, 0))(
        {k: jnp.asarray(v) for k, v in _tree(g).items()}, jst, jp)
    topt = optimizers.sgd(lr=schedules.cosine_decay(0.1, 8))
    tp, _ = topt.update(torch.from_numpy(g), {"step": torch.from_numpy(steps), "mu": None},
                        torch.from_numpy(params))
    np.testing.assert_allclose(tp.numpy(), _flat(jp), rtol=0, atol=1e-7)
