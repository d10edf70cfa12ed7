"""The port's baseline models (LR, N-BEATS, N-HiTS, gradient-boosted
trees) against ``repro.models`` on the JAX package's own params.

JAX's nested N-BEATS/N-HiTS trees are carried over by
``params_from_numpy`` (``models.base.flatten_tree``: dotted keys,
zero-padded list indices), whose sorted keys run in
``jax.tree.leaves`` order, so the flat vectors are bitwise equal.

Tolerances: ``apply`` within ``atol=1e-6`` of JAX's (fp32 matmuls with
the bias added in another order; N-HiTS's ``linspace`` may differ in
the last bit); ``apply_nodes`` row n bitwise ``apply`` under row n's
weights; the closed-form ridge solve within ``1e-5`` (float32
``torch.linalg.solve`` against ``jnp.linalg.solve``); the GBT's trees
bitwise (the same numpy fit) and its predictions within ``1e-6``
(float32 sums of 40 leaves in the same order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import GradientBoostedTrees as JaxGBT
from repro.models import LinearModel as JaxLinear
from repro.models import NBeatsModel as JaxNBeats
from repro.models import NHiTSModel as JaxNHiTS
from repro.models import get_model as jax_get_model
from repro.models.linear import fit_closed_form as jax_fit_closed_form
from repro.models.nhits import _interp1d as jax_interp1d
from repro.models.nhits import _maxpool1d as jax_maxpool1d
from repro.utils.pytree import tree_to_vector as jax_tree_to_vector
from repro_torch.models import (
    MODEL_REGISTRY,
    GBTParams,
    GradientBoostedTrees,
    LinearModel,
    NBeatsModel,
    NHiTSModel,
    flatten_tree,
    get_model,
    params_from_numpy,
)
from repro_torch.models.base import leaf_key
from repro_torch.models.linear import fit_closed_form
from repro_torch.models.nhits import _interp1d, _maxpool1d
from repro_torch.utils.pytree import ParamLayout, tree_to_vector

L, HIDDEN = 12, 8
MODELS = {
    "lr": (JaxLinear, LinearModel, {}),
    "nbeats": (JaxNBeats, NBeatsModel, {}),
    "nhits": (JaxNHiTS, NHiTSModel, {}),
    "nbeats-wide": (JaxNBeats, NBeatsModel, dict(num_blocks=11, num_layers=2)),
}


def _x(n=50, seed=0):
    return np.random.default_rng(seed).normal(size=(n, L)).astype(np.float32)


def _jax_params(jcls, kw, key):
    params = jcls(hidden=HIDDEN, **kw).init(jax.random.PRNGKey(key))
    if jcls is JaxLinear:  # zeros at init: give the model something to compute
        rng = np.random.default_rng(key)
        params = {"w": jnp.asarray(rng.normal(size=L), jnp.float32),
                  "b": jnp.asarray(rng.normal(), jnp.float32)}
    return params


@pytest.mark.parametrize("name", MODELS)
def test_carried_params_keep_jax_leaf_order_and_port_init_shapes(name):
    jcls, cls, kw = MODELS[name]
    jparams = _jax_params(jcls, kw, 0)
    params = params_from_numpy(jparams, "cpu")
    np.testing.assert_array_equal(tree_to_vector(params).numpy(),
                                  np.asarray(jax_tree_to_vector(jparams)))
    fresh = cls(hidden=HIDDEN, **kw).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in params.items()}
    assert all(v.dtype == torch.float32 for v in fresh.values())


@pytest.mark.parametrize("name", MODELS)
def test_apply_matches_jax_on_its_params(name):
    jcls, cls, kw = MODELS[name]
    jparams = _jax_params(jcls, kw, 1)
    x = _x()
    want = np.asarray(jcls(hidden=HIDDEN, **kw).apply(jparams, jnp.asarray(x)))
    got = cls(hidden=HIDDEN, **kw).apply(params_from_numpy(jparams, "cpu"), torch.from_numpy(x))
    assert got.shape == (len(x),)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", MODELS)
def test_apply_nodes_row_is_apply_under_that_rows_weights(name):
    jcls, cls, kw = MODELS[name]
    model = cls(hidden=HIDDEN, **kw)
    rows = [params_from_numpy(_jax_params(jcls, kw, k), "cpu") for k in range(3)]
    stacked = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
    x = torch.from_numpy(_x(3 * 7).reshape(3, 7, L))
    out = model.apply_nodes(stacked, x)
    assert out.shape == (3, 7)
    for n in range(3):
        assert torch.equal(out[n], model.apply(rows[n], x[n]))


@pytest.mark.parametrize("name", ["lr", "nbeats", "nhits"])
def test_apply_nodes_gradient_matches_jax_grad(name):
    """The trainers' loss runs through ``apply_nodes``: its gradient on
    each node's batch against ``jax.grad`` of the JAX model's MSE."""
    jcls, cls, kw = MODELS[name]
    jm, model = jcls(hidden=HIDDEN, **kw), cls(hidden=HIDDEN, **kw)
    jrows = [_jax_params(jcls, kw, k) for k in range(2)]
    rows = [params_from_numpy(r, "cpu") for r in jrows]
    layout = ParamLayout.of(rows[0])
    flat = layout.flatten({k: torch.stack([r[k] for r in rows]) for k in layout.names})
    x = _x(2 * 5).reshape(2, 5, L)
    y = np.random.default_rng(3).normal(size=(2, 5)).astype(np.float32)
    p = flat.requires_grad_(True)
    pred = model.apply_nodes(layout.views(p), torch.from_numpy(x))
    torch.mean(torch.square(pred - torch.from_numpy(y)), dim=1).sum().backward()
    for n in range(2):
        jg = jax.grad(lambda q: jnp.mean(jnp.square(jm.apply(q, jnp.asarray(x[n])) - y[n])))(
            jrows[n])
        np.testing.assert_allclose(p.grad[n].numpy(), np.asarray(jax_tree_to_vector(jg)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 4, 5, 12])
def test_nhits_pooling_and_interpolation_match_jax(k):
    x = _x(6)
    np.testing.assert_array_equal(_maxpool1d(torch.from_numpy(x), k).numpy(),
                                  np.asarray(jax_maxpool1d(jnp.asarray(x), k)))
    coef = x[:, :k]
    np.testing.assert_allclose(_interp1d(torch.from_numpy(coef), L).numpy(),
                               np.asarray(jax_interp1d(jnp.asarray(coef), L)), rtol=0, atol=1e-6)
    # a leading node axis interpolates each row alike
    stacked = torch.from_numpy(np.stack([coef, 2 * coef]))
    assert torch.equal(_interp1d(stacked, L)[1], _interp1d(torch.from_numpy(2 * coef), L))


def test_fit_closed_form_matches_jax():
    x = _x(400, seed=4)
    y = (x @ np.random.default_rng(5).normal(size=L) + 0.3).astype(np.float32)
    want = jax_fit_closed_form(jnp.asarray(x), jnp.asarray(y))
    got = fit_closed_form(torch.from_numpy(x), torch.from_numpy(y))
    assert sorted(got) == sorted(want) and got["b"].shape == ()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5)


@pytest.mark.parametrize("trees,depth,lr", [(20, 3, 0.3), (40, 4, 0.15)])
def test_gbt_fit_is_bitwise_and_predict_matches_jax(trees, depth, lr):
    x = _x(600, seed=6)
    y = np.where(x[:, 3] > 0.2, 2.0, -1.0).astype(np.float32) + 0.1 * x[:, 0]
    jgbt = JaxGBT(num_trees=trees, depth=depth, lr=lr)
    gbt = GradientBoostedTrees(num_trees=trees, depth=depth, lr=lr)
    jp, p = jgbt.fit(x, y), gbt.fit(x, y)
    for f in ("feats", "thresh", "leaves"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), np.asarray(getattr(jp, f)))
    assert (p.base, p.lr, p.depth) == (jp.base, jp.lr, jp.depth)
    assert p.feats.dtype == torch.int32 and p.thresh.dtype == torch.float32
    xt = _x(200, seed=7)
    want = np.asarray(jgbt.predict(jp, jnp.asarray(xt)))
    np.testing.assert_allclose(gbt.predict(p, torch.from_numpy(xt)).numpy(), want,
                               rtol=0, atol=1e-6)
    # JAX's trees carried across as arrays predict the same
    carried = GBTParams.from_arrays(jp.feats, jp.thresh, jp.leaves, jp.base, jp.lr, jp.depth)
    assert torch.equal(gbt.predict(carried, torch.from_numpy(xt)),
                       gbt.predict(p, torch.from_numpy(xt)))
    assert np.sqrt(np.mean((gbt.predict(p, torch.from_numpy(x)).numpy() - y) ** 2)) < 0.5


def test_registry_matches_jax():
    assert sorted(MODEL_REGISTRY) == ["lr", "lstm", "nbeats", "nhits"]
    for name in MODEL_REGISTRY:
        model, jmodel = get_model(name, hidden=HIDDEN), jax_get_model(name, hidden=HIDDEN)
        assert model.name == jmodel.name == name
        params = model.init(torch.Generator().manual_seed(0))
        jparams = jmodel.init(jax.random.PRNGKey(0))
        assert tree_to_vector(params).numel() == jax_tree_to_vector(jparams).size
        assert model.apply_nodes is not None
        assert (model.apply_rows is None) == (name != "lstm")


def test_flatten_tree_keys_pad_list_indices():
    tree = {"blocks": [{"w": np.zeros(1)} for _ in range(11)], "b": np.zeros(2)}
    keys = list(flatten_tree(tree))
    assert keys[:2] == ["blocks.00.w", "blocks.01.w"] and keys[-1] == "b"
    assert sorted(keys) == ["b"] + [f"blocks.{i:02d}.w" for i in range(11)]
    assert leaf_key("stacks", (2, 3), "layers", (0, 2), "b") == "stacks.2.layers.0.b"
    flat = {"wx": np.ones(3)}
    assert flatten_tree(flat).keys() == flat.keys()
