"""The port's participation schedules and topologies against the JAX
package, bitwise.

Both sides get the same random draws: the JAX functions draw from a
key, and the port's take the uniforms ``jax.random.uniform`` gives for
that key.  Everything downstream is comparisons, exact sums of 0/1
values and one IEEE division, so masks, adjacencies, mixing matrices
and neighbor tables must be equal bit for bit (tolerance: none).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import async_sched as jsched
from repro.core import topology as jtopo
from repro_torch.core import async_sched, topology

B = 7


def _t(a):
    return torch.from_numpy(np.array(a))


def _uniform(seed, shape):
    key = jax.random.PRNGKey(seed)
    return key, np.asarray(jax.random.uniform(key, shape))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("n,ratio", [(6, 0.0), (6, 0.5), (40, 0.3), (40, 0.999999)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bernoulli_active_matches_jax(n, ratio, seed):
    key, u = _uniform(seed, (n,))
    want = jsched.bernoulli_active(key, n, ratio)
    got = async_sched.bernoulli_active(_t(u), ratio)
    _eq(got, want)
    assert got.sum() >= 1


def test_bernoulli_fallback_activates_the_largest_draw():
    """All nodes drawn inactive: the node with the largest u (the first
    of ties) is switched on, as jnp.argmax does."""
    u = torch.tensor([0.1, 0.7, 0.3, 0.7])
    _eq(async_sched.bernoulli_active(u, 0.9), np.array([0, 1, 0, 0], np.float32))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("p_active,p_inactive", [(0.9, 0.7), (0.05, 0.99)])
def test_markov_active_matches_jax(seed, p_active, p_inactive):
    n = 40
    key, u = _uniform(seed, (n,))
    prev = (np.random.default_rng(seed).random(n) < 0.5).astype(np.float32)
    want = jsched.markov_active(key, jnp.asarray(prev), p_active, p_inactive)
    got = async_sched.markov_active(_t(u), _t(prev), p_active, p_inactive)
    _eq(got, want)


def test_markov_fallback_is_argmin_of_u_minus_stay():
    prev = torch.tensor([1.0, 0.0, 1.0])
    u = torch.tensor([0.95, 0.02, 0.97])
    # stay = (0.9, 0.01, 0.9): nobody activates; u - stay = (0.05, 0.01,
    # 0.07) is smallest at node 1
    _eq(async_sched.markov_active(u, prev, 0.9, 0.99), np.array([0, 1, 0], np.float32))


def test_staleness_update_matches_jax():
    s = np.array([0, 3, 1, 0, 7], np.float32)
    a = np.array([1, 0, 0, 1, 1], np.float32)
    _eq(async_sched.staleness_update(_t(s), _t(a)),
        jsched.staleness_update(jnp.asarray(s), jnp.asarray(a)))


# ------------------------------------------------------------- topology


@pytest.mark.parametrize("topo", ["ring", "cluster", "star", "full"])
@pytest.mark.parametrize("n", [1, 2, 6, 13, 40])
def test_static_adjacency_matches_jax(topo, n):
    _eq(topology.static_adjacency(topo, n, 4), jtopo.static_adjacency(topo, n, 4))


@pytest.mark.parametrize("n", [6, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_adjacency_matches_jax(n, seed):
    key, scores = _uniform(seed, (n, n))
    want = jtopo.random_adjacency(key, n, min(B, n - 1))
    _eq(topology.random_adjacency(_t(scores), min(B, n - 1)), want)


def _active(n, seed, ratio=0.5):
    key, u = _uniform(100 + seed, (n,))
    return np.asarray(jsched.bernoulli_active(key, n, ratio))


@pytest.mark.parametrize("topo", ["ring", "cluster", "star", "full", "random"])
@pytest.mark.parametrize("n", [6, 40])
def test_mixing_matrix_and_tables_match_jax_bitwise(topo, n):
    seed = n
    key, scores = _uniform(seed, (n, n))
    jadj = jtopo.round_adjacency(topo, n, key, B)
    adj = topology.round_adjacency(topo, n, _t(scores), B)
    _eq(adj, jadj)
    act = _active(n, seed)
    jm = jtopo.mixing_matrix(jadj, jnp.asarray(act), B)
    m = topology.mixing_matrix(adj, _t(act), B)
    _eq(m, jm)
    jidx, jwgt = jtopo.neighbor_table(jadj, jnp.asarray(act), B)
    idx, wgt = topology.neighbor_table(adj, _t(act), B)
    _eq(idx, jidx)
    _eq(wgt, jwgt)
    _eq(topology.densify_neighbor_table(idx, wgt), jm)
    cand = topology.neighbor_candidates(topo, n)
    jcand = jtopo.neighbor_candidates(topo, n)
    if topo == "random":
        assert cand is None and jcand is None
        return
    _eq(cand[0], jcand[0])
    _eq(cand[1], jcand[1])
    cidx, cwgt = topology.neighbor_table_from_candidates(*cand, _t(act), B)
    jcidx, jcwgt = jtopo.neighbor_table_from_candidates(*jcand, jnp.asarray(act), B)
    _eq(cidx, jcidx)
    _eq(cwgt, jcwgt)
    _eq(topology.densify_neighbor_table(cidx, cwgt), jm)


def test_mixing_matrix_cap_keeps_lowest_index():
    """The B lowest-index active neighbours are kept (the JAX package's
    test_mixing_matrix_cap_keeps_lowest_index, on the port)."""
    n = 6
    adj = topology.full_adjacency(n)
    m = topology.mixing_matrix(adj, torch.ones(n), 2)
    assert torch.equal(m[5] > 0, torch.tensor([True, True, False, False, False, True]))
    assert torch.equal(m[0] > 0, torch.tensor([True, True, True, False, False, False]))


def test_neighbor_table_tie_order_cannot_show():
    """Non-kept candidate slots tie at -inf in the compaction's top-k;
    whatever order torch.topk leaves them in, they come out with weight
    0 and index self."""
    cand = torch.tensor([[1, 2, 3, 4], [0, 2, 3, 4], [0, 1, 3, 4], [0, 1, 2, 4], [0, 1, 2, 3]],
                        dtype=torch.int32)
    valid = torch.ones(cand.shape)
    act = torch.tensor([1.0, 0.0, 0.0, 1.0, 0.0])
    idx, wgt = topology.neighbor_table_from_candidates(cand, valid, act, 3)
    assert idx.shape == (5, 4)
    pad = wgt == 0
    assert torch.equal(idx[pad], torch.arange(5, dtype=torch.int32)[:, None].expand(5, 4)[pad])
    assert torch.equal(idx[0], torch.tensor([0, 3, 0, 0], dtype=torch.int32))
    assert torch.equal(wgt[1], torch.tensor([1.0, 0, 0, 0]))
