"""The port's gossip mixing against the JAX package: the four plain twins
of the CUDA gossip kernels against ``repro.kernels.ops.gossip_mix*``
(the Pallas kernels in interpret mode, as the JAX package's own tests
run them), the tree paths against ``repro.core.gossip``, the DP stages
of the resolved plan against ``repro.core.gossip_plan``, the plan's
refusals, and the wrapper's checks.

Inputs: N in {6, 40} nodes of an H=8 LSTM (D = 329), real mixing
matrices and neighbor tables (B=7, half the nodes active), weights and
noise from numpy with a seed.

Tolerance: ``atol=1e-6``.  Every output is an fp32 sum of at most B+1
row-stochastic weights times values of magnitude ~1 (the dense matrix's
other weights are exact zeros); the two sides sum in different orders
(a matmul against a loop of multiply-adds), which moves a result by a
few ulps.  Inactive rows are compared bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.core import gossip_plan as jplan
from repro.core import topology as jtopo
from repro.kernels import ops as jops
from repro.kernels.ref import gossip_mix_ref
from repro_torch.core import gossip, gossip_plan
from repro_torch.kernels import gossip_mix as gossip_kernels
from repro_torch.kernels import ops, ref
from repro_torch.utils.pytree import ParamLayout

ATOL = 1e-6
B = 7
H = 8
SHAPES = {"b": (4 * H,), "b_out": (1,), "w_out": (H, 1), "wh": (H, 4 * H), "wx": (1, 4 * H)}
LAYOUT = ParamLayout(tuple(SHAPES), tuple(SHAPES.values()), (0, 32, 33, 41, 297), 329)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(n, seed, topo="random"):
    """A round's operands: stacked params (dict of (N, ...) arrays),
    their flat (N, D) matrix, DP noise, the active mask, the dense
    mixing matrix and the neighbor table (numpy)."""
    rng = np.random.default_rng(seed)
    stacked = {k: rng.normal(size=(n,) + s).astype(np.float32) for k, s in SHAPES.items()}
    flat = np.concatenate([stacked[k].reshape(n, -1) for k in sorted(stacked)], axis=1)
    noise = (0.01 * rng.normal(size=flat.shape)).astype(np.float32)
    act = (rng.random(n) >= 0.5).astype(np.float32)
    act[0] = 1.0
    key = jax.random.PRNGKey(seed)
    adj = jtopo.round_adjacency(topo, n, key, B)
    mix = np.asarray(jtopo.mixing_matrix(adj, jnp.asarray(act), B))
    idx, wgt = (np.asarray(a) for a in jtopo.neighbor_table(adj, jnp.asarray(act), B))
    return stacked, flat, noise, act, mix, idx, wgt


def _close(got, want, act=None, base=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)
    if act is not None:
        np.testing.assert_array_equal(got[act == 0], base[act == 0])


def test_layout_matches_the_lstm_leaves():
    from repro_torch.models import LSTMModel

    params = LSTMModel(hidden=H).init(torch.Generator().manual_seed(0))
    assert ParamLayout.of(params) == LAYOUT
    flat = LAYOUT.flatten({k: v[None] for k, v in params.items()})
    views = LAYOUT.views(flat)
    assert all(torch.equal(views[k][0], params[k]) for k in params)


# ------------------------------------------------ twins vs Pallas kernels


@pytest.mark.parametrize("n", [6, 40])
def test_plain_twins_match_pallas_kernels(n):
    _, w, z, act, mix, idx, wgt = _case(n, seed=n)
    j = {k: jnp.asarray(v) for k, v in dict(w=w, z=z, act=act, mix=mix, idx=idx, wgt=wgt).items()}
    tw, tz, tact, tmix, tidx, twgt = (_t(a) for a in (w, z, act, mix, idx, wgt))
    _close(ref.gossip_mix_plain(tmix, tw, tact), jops.gossip_mix(j["mix"], j["w"], j["act"]), act, w)
    _close(ref.gossip_mix_sparse_plain(tidx, twgt, tw, tact),
           jops.gossip_mix_sparse(j["idx"], j["wgt"], j["w"], j["act"]), act, w)
    _close(ref.gossip_mix_dp_plain(tmix, tw, tz, tact),
           jops.gossip_mix_dp(j["mix"], j["w"], j["z"], j["act"]), act, w)
    _close(ref.gossip_mix_sparse_dp_plain(tidx, twgt, tw, tz, tact),
           jops.gossip_mix_sparse_dp(j["idx"], j["wgt"], j["w"], j["z"], j["act"]), act, w)


@pytest.mark.parametrize("n", [6, 40])
def test_cpu_dispatch_runs_the_twins_without_launching(n):
    _, w, z, act, mix, idx, wgt = _case(n, seed=1)
    tw, tz, tact, tmix, tidx, twgt = (_t(a) for a in (w, z, act, mix, idx, wgt))
    before = dict(gossip_kernels.LAUNCHES)
    assert torch.equal(ops.gossip_mix(tmix, tw, tact), ref.gossip_mix_plain(tmix, tw, tact))
    assert torch.equal(ops.gossip_mix_sparse(tidx, twgt, tw, tact),
                       ref.gossip_mix_sparse_plain(tidx, twgt, tw, tact))
    assert torch.equal(ops.gossip_mix_dp(tmix, tw, tz, tact),
                       ref.gossip_mix_dp_plain(tmix, tw, tz, tact))
    assert torch.equal(ops.gossip_mix_sparse_dp(tidx, twgt, tw, tz, tact),
                       ref.gossip_mix_sparse_dp_plain(tidx, twgt, tw, tz, tact))
    assert gossip_kernels.LAUNCHES == before


def test_dense_blend_nan_difference_is_pinned():
    """A NaN in an active row.  The JAX dense kernel and its oracle blend
    ``act*mixed + (1-act)*w``, so 0*NaN reaches every inactive row; the
    port where-selects, so inactive rows stay bitwise copies.  Active
    rows are NaN on both sides (0*NaN is NaN in the contraction too)."""
    n = 6
    _, w, _, _, _, _, _ = _case(n, seed=3)
    act = np.array([1, 1, 0, 1, 0, 1], np.float32)
    mix = np.asarray(jtopo.mixing_matrix(jtopo.full_adjacency(n), jnp.asarray(act), B))
    w[0, 5] = np.nan
    inactive = act == 0
    want_ref = np.asarray(gossip_mix_ref(jnp.asarray(mix), jnp.asarray(w), jnp.asarray(act)))
    want_kernel = np.asarray(jops.gossip_mix(jnp.asarray(mix), jnp.asarray(w), jnp.asarray(act)))
    got = ref.gossip_mix_plain(_t(mix), _t(w), _t(act)).numpy()
    assert np.isnan(want_ref[inactive, 5]).all() and np.isnan(want_kernel[inactive, 5]).all()
    np.testing.assert_array_equal(got[inactive], w[inactive])
    assert np.isnan(got[act > 0, 5]).all()


# ------------------------------------------------------------ tree paths


@pytest.mark.parametrize("n", [6, 40])
def test_tree_paths_match_jax(n):
    stacked, w, _, act, mix, idx, wgt = _case(n, seed=10 + n)
    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}

    def flat(tree):
        return np.concatenate([np.asarray(tree[k]).reshape(n, -1) for k in sorted(tree)], axis=1)

    _close(gossip.gossip_mix_tree(_t(w), _t(mix)), flat(jgossip.gossip_mix_tree(jstacked, jnp.asarray(mix))))
    want = flat(jgossip.gossip_mix_sparse_tree(jstacked, jnp.asarray(idx), jnp.asarray(wgt),
                                               jnp.asarray(act)))
    _close(gossip.gossip_mix_sparse_tree(_t(w), _t(idx), _t(wgt), _t(act)), want, act, w)


def test_pytree_mix_and_mean_match_jax():
    """``tree_weighted_mix`` and ``tree_mean`` on a stacked dict, against
    ``repro.utils.pytree``."""
    from repro.utils import pytree as jpytree
    from repro_torch.utils import pytree

    stacked, _, _, _, mix, _, _ = _case(6, seed=5)
    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    tstacked = {k: _t(v) for k, v in stacked.items()}
    want = jpytree.tree_weighted_mix(jstacked, jnp.asarray(mix))
    got = pytree.tree_weighted_mix(tstacked, _t(mix))
    want_mean = jpytree.tree_mean(jstacked)
    got_mean = pytree.tree_mean(tstacked)
    for k in SHAPES:
        _close(got[k], want[k])
        _close(got_mean[k], want_mean[k])


# ------------------------------------------------------- the plan's stages


@pytest.mark.parametrize("mixer", ["tree", "kernel"])
@pytest.mark.parametrize("repr_,n", [("dense", 6), ("sparse", 40)])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_plan_gossip_matches_jax_plan(mixer, repr_, n, sigma):
    """The whole gossip stage, plain or local-DP (fused for the kernel
    mixer, composed for the tree mixer), from the same noise."""
    stacked, w, _, act, mix, idx, wgt = _case(n, seed=20 + n)
    jp = jplan.resolve_gossip_plan(mixer=mixer, gossip_repr=repr_, dp_noise_sigma=sigma,
                                   num_nodes=n, comm_batch=B)
    tp = gossip_plan.resolve_gossip_plan(mixer=mixer, gossip_repr=repr_, num_nodes=n,
                                         comm_batch=B)
    jstacked = {k: jnp.asarray(v) for k, v in stacked.items()}
    operand = (jnp.asarray(idx), jnp.asarray(wgt)) if repr_ == "sparse" else jnp.asarray(mix)
    k_dp = jax.random.PRNGKey(7) if sigma else None
    out = jp.gossip(jstacked, operand, jnp.asarray(act), k_dp)
    want = np.concatenate([np.asarray(out[k]).reshape(n, -1) for k in sorted(out)], axis=1)
    noise = None
    if sigma:
        keys = jax.random.split(k_dp, len(stacked))
        noise = sigma * _t(np.concatenate(
            [np.asarray(jax.random.normal(kk, stacked[k].shape)).reshape(n, -1)
             for kk, k in zip(keys, sorted(stacked))], axis=1))
    t_operand = (_t(idx), _t(wgt)) if repr_ == "sparse" else _t(mix)
    got = tp.gossip(_t(w), t_operand, _t(act), noise)
    # the tree mixer's dense DP composition does not restore inactive
    # rows (the trainer's where-mask does); everything else selects them
    bitwise_inactive = not (mixer == "tree" and repr_ == "dense" and sigma)
    _close(got, want, *((act, w) if bitwise_inactive else ()))


@pytest.mark.parametrize("n,expect", [(12, "dense"), (31, "dense"), (32, "sparse"), (226, "sparse")])
def test_choose_gossip_repr_matches_jax(n, expect):
    assert gossip_plan.choose_gossip_repr(n, B) == jplan.choose_gossip_repr(n, B) == expect


def test_auto_repr_and_static_candidates():
    plan = gossip_plan.resolve_gossip_plan(gossip_repr="auto", num_nodes=226, comm_batch=B,
                                           topology="ring")
    assert plan.gossip_repr == "sparse" and plan.neighbor_cand is not None
    plan = gossip_plan.resolve_gossip_plan(gossip_repr="auto", num_nodes=12, comm_batch=B,
                                           topology="ring")
    assert plan.gossip_repr == "dense" and plan.neighbor_cand is None


@pytest.mark.parametrize("knobs,word", [
    (dict(mixer="sharded"), "mixer='sharded'"),
    (dict(mixer="pallas"), "mixer 'pallas'"),
    (dict(gossip_repr="csr"), "gossip_repr 'csr'"),
])
def test_plan_refuses_what_is_not_ported(knobs, word):
    """Unknown knob values are refused, naming the knob; the sharded
    mixer, refused before it was ported, resolves to the sharded backend
    on the one-process mesh."""
    if knobs.get("mixer") == "sharded":
        plan = gossip_plan.resolve_gossip_plan(num_nodes=8, comm_batch=2, **knobs)
        assert (plan.backend, plan.mesh.width, plan.rows) == ("sharded", 1, slice(0, 8))
        return
    with pytest.raises(gossip_plan.GossipPlanError, match=word):
        gossip_plan.resolve_gossip_plan(num_nodes=8, comm_batch=2, **knobs)


# ------------------------------------------------------------ the wrapper


def test_wrapper_refuses_grad_then_cpu_tensors():
    """With grad mode on, an operand that requires grad is refused first
    (the kernel has no backward); CPU tensors are refused next."""
    _, w, z, act, mix, idx, wgt = _case(6, seed=4)
    tw = _t(w).requires_grad_(True)
    before = dict(gossip_kernels.LAUNCHES)
    with pytest.raises(RuntimeError, match="w require"):
        gossip_kernels.gossip_mix(_t(mix), tw, _t(act))
    with pytest.raises(RuntimeError, match="w require"):
        gossip_kernels.gossip_mix_sparse_dp(_t(idx), _t(wgt), tw, _t(z), _t(act))
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        gossip_kernels.gossip_mix(_t(mix), tw, _t(act))
    with pytest.raises(ValueError, match="CUDA"):
        gossip_kernels.gossip_mix_sparse(_t(idx), _t(wgt), _t(w), _t(act))
    with pytest.raises(ValueError, match="meta"):
        ops.gossip_mix(_t(mix).to("meta"), _t(w).to("meta"), _t(act).to("meta"))
    assert gossip_kernels.LAUNCHES == before


# ------------------------------------------------------- the kernel's plan


@pytest.mark.parametrize("kernel,n,s,design,tile", [
    ("gossip_mix", 12, 0, "staged", 256),             # OhioT1DM
    ("gossip_mix_sparse_dp", 226, 8, "staged", 32),   # REPLACE-BG
    ("gossip_mix_sparse", 226, 8, "rowwise", 1024),   # no staged design
    ("gossip_mix_dp", 12, 0, "staged", 256)])         # OhioT1DM with DP
def test_gossip_plan_at_the_main_path_shapes(kernel, n, s, design, tile):
    plan = gossip_kernels._plan(kernel, n, s, 66_689)
    assert (plan.design, plan.tile) == (design, tile)
    if kernel == "gossip_mix_sparse_dp":  # three blocks share an H100 SM (228 KB, 1 KB a block)
        assert 3 * (plan.smem + 1024) <= 228 * 1024 and 3 * plan.threads <= 2048


@pytest.mark.parametrize("kernel,s", [("gossip_mix", 0), ("gossip_mix_dp", 0),
                                      ("gossip_mix_sparse_dp", 8)])
def test_gossip_plan_stages_while_the_tile_fits(kernel, s):
    """Staged up to the largest N whose tile and operator fit in a block's
    shared memory, row-wise from the next N on, whatever D is."""
    sparse, dp = "sparse" in kernel, kernel.endswith("_dp")
    tile = gossip_kernels.STAGED_TILE[kernel]
    for d in (1, 513, 66_689):
        plans = [gossip_kernels._plan(kernel, n, s, d) for n in range(1, 1200)]
        staged = [n for n, plan in enumerate(plans, 1) if plan.design == "staged"]
        limit = staged[-1]
        assert staged == list(range(1, limit + 1))
        assert gossip_kernels._smem_bytes(limit, s, tile, sparse, dp) <= gossip_kernels.SMEM_LIMIT
        assert gossip_kernels._smem_bytes(limit + 1, s, tile, sparse, dp) > gossip_kernels.SMEM_LIMIT
        assert all(plan.smem == gossip_kernels._smem_bytes(n, s, tile, sparse, dp)
                   for n, plan in enumerate(plans[:limit], 1))
        assert {(p.tile, p.threads) for p in plans[:limit]} == {
            (tile, gossip_kernels.STAGED_THREADS[kernel])}


def test_gossip_smem_layout_words():
    """The staged layout of ``csrc/gossip_mix.cu``: the operator padded to
    multiples of 4 words, the mask, the W (and Z) tile."""
    assert gossip_kernels._smem_bytes(12, 0, 256, False, False) == 4 * (12 * 12 + 12 + 12 * 256)
    assert gossip_kernels._smem_bytes(5, 0, 32, False, False) == 4 * (5 * 8 + 8 + 5 * 32)
    assert gossip_kernels._smem_bytes(12, 0, 256, False, True) == 4 * (12 * 12 + 12 + 2 * 12 * 256)
    assert gossip_kernels._smem_bytes(95, 0, 256, False, True) == 4 * (95 * 96 + 96 + 2 * 95 * 256)
    assert gossip_kernels._smem_bytes(226, 8, 32, True, True) == 4 * (2 * 226 * 8 + 228 + 2 * 226 * 32)
    assert gossip_kernels._smem_bytes(3, 5, 64, True, True) == 4 * (2 * 3 * 8 + 4 + 2 * 3 * 64)
