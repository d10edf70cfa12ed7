"""The port's pairwise-masked secure aggregation
(``gossip_impl="masked"``) against ``repro.core.secure_agg``, mirroring
``tests/test_secure_agg.py`` on one process (its sharded and swept
tests wait for the port's sharded mixer and sweep engine):

  * the weighted mask sum is exactly ``+0.0``, with dropouts too;
  * given JAX's masks (``_edge_masks`` per leaf under
    ``fold_in(round key, MASK_STREAM_TAG)`` and ``split_like``,
    concatenated in ``ParamLayout`` order), the port's zeroed masks,
    signs, cancellation term and ``simulate_wires`` equal JAX's bitwise;
  * the production mask source shares each edge's vector between the
    rows that hold it, and no simulated wire equals raw params; dropped
    rows put nothing masked on the wire; the books balance;
  * masked training is bitwise unmasked training (params, optimizer
    rows and the round generator's state) on both mixers, both
    representations and DP off or on;
  * one masked round from JAX-drawn ``RoundDraws`` and JAX's masks
    matches JAX's masked round within the one-round SGD tolerance of
    ``tests/test_torch_train.py`` (1e-6: the gradient's summation order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JaxFLConfig
from repro.core import GluADFL as JaxGluADFL
from repro.core.secure_agg import MASK_STREAM_TAG as JAX_MASK_STREAM_TAG
from repro.core.secure_agg import _edge_masks, _pair_slots
from repro.core.secure_agg import masked_mix_zero as jax_masked_mix_zero
from repro.core.secure_agg import simulate_wires as jax_simulate_wires
from repro.models import LSTMModel as JaxLSTM
from repro.optim import get_optimizer as jax_get_optimizer
from repro.utils.rng import split_like
from repro_torch.config import FLConfig
from repro_torch.core import GluADFL, GossipPlanError, choose_gossip_impl, resolve_gossip_plan
from repro_torch.core.gossip import gossip_mix_sparse_tree, gossip_mix_masked
from repro_torch.core.secure_agg import (
    MASK_STREAM_TAG,
    edge_mask_source,
    edge_masks,
    mask_generator,
    masked_mix_zero,
    pair_slots,
    simulate_wires,
)
from repro_torch.core.topology import densify_neighbor_table, neighbor_table, random_adjacency
from repro_torch.models import LSTMModel
from repro_torch.optim import adam, get_optimizer

from test_torch_train import _data, _flat, jax_draws


def _table(n=8, b=3, seed=0, active=None):
    gen = torch.Generator().manual_seed(seed)
    adj = random_adjacency(torch.rand((n, n), generator=gen), b)
    active = torch.ones(n) if active is None else torch.as_tensor(active, dtype=torch.float32)
    idx, wgt = neighbor_table(adj, active, b)
    return idx, wgt


def _source(d, seed=3):
    return edge_mask_source(torch.Generator().manual_seed(seed), d)


def _stacked(n, shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(n, *s)).astype(np.float32) for k, s in shapes.items()}


def jax_mask_source(key, stacked):
    """The masks JAX's round would draw under mask key ``key`` for the
    leaves of ``stacked`` ((N, ...) each), as a port mask source: per
    leaf ``_edge_masks`` under ``split_like(key, stacked)``, the leaves
    concatenated in sorted (``ParamLayout``) order."""
    keys = split_like(key, stacked)

    def source(idx, wgt):
        jidx, jwgt = jnp.asarray(idx.numpy()), jnp.asarray(wgt.numpy())
        parts = [np.asarray(_edge_masks(keys[k], jidx, jwgt, math.prod(stacked[k].shape[1:]))[0])
                 for k in sorted(stacked)]
        return torch.from_numpy(np.concatenate(parts, axis=2))

    return source


def _zero_and_positive(t):
    return bool((t == 0).all()) and not bool(torch.signbit(t).any())


# ------------------------------------------------------ the exact-zero core


def test_mask_cancellation_is_exactly_zero():
    idx, wgt = _table()
    masks = _source(17)(idx, wgt)
    assert masks.shape == (8, 6, 17)  # 4 slots at B=3: 6 pairs
    assert _zero_and_positive(masked_mix_zero(idx, wgt, masks))


def test_mask_cancellation_zero_with_dropouts():
    idx, wgt = _table(active=[1, 0, 1, 1, 0, 0, 1, 1])
    zero = masked_mix_zero(idx, wgt, _source(33)(idx, wgt))
    assert _zero_and_positive(zero)
    w = torch.randn((8, 33), generator=torch.Generator().manual_seed(1))
    w[2, 3] = -0.0
    mixed = gossip_mix_sparse_tree(w, idx, wgt)
    out = gossip_mix_masked(mixed, idx, wgt, _source(33)(idx, wgt))
    # bitwise, but for the sign of zero: +0.0 added to -0.0 is +0.0, as in JAX
    assert torch.equal(out, mixed)
    assert torch.equal(out.view(torch.int32), (mixed + 0.0).view(torch.int32))


# --------------------------------------------------------- against JAX


@pytest.mark.parametrize("active", [None, [1, 0, 1, 1, 0, 1, 1, 1]])
def test_masks_term_and_wires_match_jax_given_jax_masks(active):
    idx, wgt = _table(active=active, seed=2)
    stacked = _stacked(8, {"a": (3, 5), "b": (17,), "c": (1,)}, seed=3)
    key = jax.random.fold_in(jax.random.PRNGKey(4), JAX_MASK_STREAM_TAG)
    source = jax_mask_source(key, stacked)
    masks = source(idx, wgt)
    jidx, jwgt = jnp.asarray(idx.numpy()), jnp.asarray(wgt.numpy())
    keys = split_like(key, stacked)
    z, sign_a, pa, pb = edge_masks(idx, wgt, masks)
    offset = 0
    for k in sorted(stacked):
        dim = math.prod(stacked[k].shape[1:])
        jz, jsign, jpa, jpb = _edge_masks(keys[k], jidx, jwgt, dim)
        np.testing.assert_array_equal(z[..., offset:offset + dim].numpy(), np.asarray(jz))
        np.testing.assert_array_equal(sign_a.numpy(), np.asarray(jsign))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(jpa))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jpb))
        offset += dim
    flat = torch.from_numpy(_flat(stacked, 8))
    jzero = jax_masked_mix_zero({k: jnp.asarray(v) for k, v in stacked.items()}, jidx, jwgt, key)
    np.testing.assert_array_equal(masked_mix_zero(idx, wgt, masks).numpy(),
                                  _flat({k: np.asarray(v) for k, v in jzero.items()}, 8))
    jwires = jax_simulate_wires({k: jnp.asarray(v) for k, v in stacked.items()}, jidx, jwgt, key)
    want = np.concatenate([np.asarray(jwires[k]) for k in sorted(stacked)], axis=2)
    np.testing.assert_array_equal(simulate_wires(flat, idx, wgt, masks).numpy(), want)
    assert pair_slots(4) == tuple(tuple(p) for p in _pair_slots(4))
    assert MASK_STREAM_TAG == JAX_MASK_STREAM_TAG


# -------------------------------------------------- the production source


def test_edge_mask_source_shares_each_edge_and_nothing_else():
    n, d = 12, 9
    idx, wgt = _table(n=n, b=5, seed=5, active=[1] * 9 + [0] * 3)
    masks = _source(d)(idx, wgt)
    z, _, pa, pb = edge_masks(idx, wgt, masks)
    seen = {}
    for row in range(n):
        for p in range(pa.numel()):
            u, v = int(idx[row, pa[p]]), int(idx[row, pb[p]])
            if wgt[row, pa[p]] > 0 and wgt[row, pb[p]] > 0 and u != v:
                edge = (min(u, v), max(u, v))
                if edge in seen:
                    assert torch.equal(z[row, p], seen[edge]), edge
                seen[edge] = z[row, p]
            else:
                assert bool((z[row, p] == 0).all())
    vectors = torch.stack(list(seen.values()))
    assert len(seen) > n and torch.unique(vectors, dim=0).shape[0] == len(seen)
    # the draw count does not depend on the round: one vector per (row, pair)
    gen = torch.Generator().manual_seed(6)
    edge_mask_source(gen, d)(idx, wgt)
    after = torch.Generator().manual_seed(6)
    torch.randn((n * pa.numel(), d), generator=after)
    assert torch.equal(gen.get_state(), after.get_state())


def test_wires_never_equal_raw_params():
    idx, wgt = _table()
    w = torch.randn((8, 29), generator=torch.Generator().manual_seed(6))
    wires = simulate_wires(w, idx, wgt, _source(29, seed=7)(idx, wgt))
    checked = 0
    for n in range(8):
        valid = wgt[n] > 0
        if int(valid.sum()) < 2:
            continue
        for b in torch.nonzero(valid)[:, 0].tolist():
            assert not torch.equal(wires[n, b], w[idx[n, b]]), (n, b)
            checked += 1
    assert checked > 0


def test_dropped_rows_put_nothing_masked_on_the_wire():
    idx, wgt = _table(active=[1, 0, 1, 1, 1, 1, 1, 1])
    w = torch.randn((8, 13), generator=torch.Generator().manual_seed(8))
    wires = simulate_wires(w, idx, wgt, _source(13, seed=9)(idx, wgt))
    assert torch.equal(wires[1, 0], w[1]) and float(wgt[1, 0]) == 1.0


def test_wire_books_balance():
    idx, wgt = _table()
    w = torch.randn((8, 21), generator=torch.Generator().manual_seed(10))
    wires = simulate_wires(w, idx, wgt, _source(21, seed=11)(idx, wgt))
    mixed = torch.einsum("nb,nbd->nd", wgt, wires)
    np.testing.assert_allclose(mixed.numpy(), (densify_neighbor_table(idx, wgt) @ w).numpy(),
                               rtol=0, atol=1e-4)


# -------------------------------------------------- the trainer, bitwise


def _fed(n=8, m=20, steps=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, m, steps)).astype(np.float32)
    y = rng.normal(size=(n, m)).astype(np.float32)
    return x, y, np.full((n,), m, np.int32)


def _train(gossip_impl, *, repr_, sigma, mixer, rounds=4):
    x, y, counts = _fed()
    cfg = FLConfig(topology="random", num_nodes=8, rounds=rounds, comm_batch=3,
                   inactive_ratio=0.5)  # dropouts every round
    tr = GluADFL(LSTMModel(history_len=6, hidden=4).as_model(), adam(1e-2), cfg,
                 gossip_impl=gossip_impl, gossip_repr=repr_, dp_noise_sigma=sigma, mixer=mixer,
                 device="cpu")
    gen = torch.Generator().manual_seed(7)
    _, hist, state = tr.train(gen, x, y, counts, batch_size=8, chunk=2)
    return tr, hist, state, gen


@pytest.mark.parametrize("mixer", ["tree", "kernel"])
@pytest.mark.parametrize("repr_", ["dense", "sparse"])
@pytest.mark.parametrize("sigma", [0.0, 0.05])
def test_masked_training_bitwise_equals_unmasked(mixer, repr_, sigma):
    _, ha, a, ga = _train("allgather", repr_=repr_, sigma=sigma, mixer=mixer)
    tr, hb, b, gb = _train("masked", repr_=repr_, sigma=sigma, mixer=mixer)
    assert tr.plan.masked and tr.mask_source is not None
    assert torch.equal(a.params, b.params)
    assert a.opt_state.keys() == b.opt_state.keys()
    assert all(torch.equal(a.opt_state[k], b.opt_state[k]) for k in a.opt_state)
    assert ha == hb
    # the masks never draw from the round generator
    assert torch.equal(ga.get_state(), gb.get_state())


@pytest.mark.parametrize("repr_,topology", [("dense", "random"), ("sparse", "random"),
                                             ("dense", "ring"), ("sparse", "ring")])
def test_masked_round_matches_jax_masked_round(repr_, topology):
    """One masked round from JAX's state, draws and masks: the mask
    table comes from the round's adjacency (dense), the operand (sparse)
    or the static topology's candidates (sparse ring)."""
    n = 40 if repr_ == "sparse" else 6
    x, y, counts = _data(n, seed=n)
    fl = dict(num_nodes=n, comm_batch=7, inactive_ratio=0.5, topology=topology)
    jt = JaxGluADFL(JaxLSTM(hidden=8).as_model(), jax_get_optimizer("sgd", 1e-2),
                    JaxFLConfig(**fl), gossip_impl="masked", gossip_repr=repr_)
    js = jt.init(jax.random.PRNGKey(n))
    js2, jloss = jt._round_jit(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(counts),
                               batch_size=8)
    params = {k: np.asarray(v) for k, v in js.params.items()}
    seen = []
    source = jax_mask_source(jax.random.fold_in(js.key, JAX_MASK_STREAM_TAG), params)

    def recording(idx, wgt):
        masks = source(idx, wgt)
        seen.append(masks)
        return masks

    tt = GluADFL(LSTMModel(hidden=8).as_model(), get_optimizer("sgd", 1e-2), FLConfig(**fl),
                 gossip_impl="masked", gossip_repr=repr_, mask_source=recording, device="cpu")
    ts = tt.state_from_params(params)
    _, draws = jax_draws(js.key, n, counts, random_topology=topology == "random")
    ts2, loss = tt.round(ts, tt.to_device(x, y, counts), draws)
    assert len(seen) == 1 and bool((seen[0] != 0).any())
    np.testing.assert_allclose(ts2.params.numpy(), _flat(js2.params, n), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts2.staleness.numpy(), np.asarray(js2.staleness))


# ------------------------------------------------------------ knob plumbing


def test_choose_gossip_impl_and_the_sharded_schedules():
    """``choose_gossip_impl(N, bytes a node)`` as the JAX package's:
    masked when secure, allgather on one shard or while the gathered
    federation fits the budget, psum past it, and a secure request past
    it refused.  The plan takes ``psum`` on any mixer and ``gather``
    only on the sharded one."""
    assert choose_gossip_impl(8, 1000, secure=True) == "masked"
    assert choose_gossip_impl(8, 1000) == "allgather"  # the one-process mesh: one shard
    assert choose_gossip_impl(8, 1 << 40, shards=1) == "allgather"
    assert choose_gossip_impl(8, 1000, shards=2, budget_bytes=8000) == "allgather"
    assert choose_gossip_impl(8, 1001, shards=2, budget_bytes=8000) == "psum"
    with pytest.raises(GossipPlanError, match="budget"):
        choose_gossip_impl(8, 1001, shards=2, budget_bytes=8000, secure=True)
    plan = resolve_gossip_plan(gossip_impl="allgather", num_nodes=8, comm_batch=2)
    assert plan.gossip_impl == "allgather" and not plan.masked
    assert resolve_gossip_plan(gossip_impl="masked", num_nodes=8, comm_batch=2).masked
    with pytest.raises(GossipPlanError, match="'auto' resolves through choose_gossip_impl"):
        resolve_gossip_plan(gossip_impl="auto", num_nodes=8, comm_batch=2)
    assert resolve_gossip_plan(gossip_impl="psum", num_nodes=8, comm_batch=2).backend == "tree"
    with pytest.raises(GossipPlanError, match="needs mixer in \\['sharded'\\]"):
        resolve_gossip_plan(gossip_impl="gather", num_nodes=8, comm_batch=2)
    plan = resolve_gossip_plan(mixer="sharded", gossip_impl="gather", gossip_repr="sparse",
                               num_nodes=8, comm_batch=2)
    assert plan.backend == "sharded_gather_tables"
    with pytest.raises(GossipPlanError, match="needs gossip_repr='sparse'"):
        resolve_gossip_plan(mixer="sharded", gossip_impl="gather", num_nodes=8, comm_batch=2)
    cfg = FLConfig(num_nodes=4, comm_batch=2)
    with pytest.raises(GossipPlanError):
        GluADFL(LSTMModel(hidden=4).as_model(), adam(1e-3), cfg, gossip_impl="bogus",
                device="cpu")
    with pytest.raises(ValueError, match="mask_source"):
        GluADFL(LSTMModel(hidden=4).as_model(), adam(1e-3), cfg, mask_source=_source(4),
                device="cpu")


def test_mask_generator_is_seeded_apart_from_the_trainer_seed():
    a = torch.randn(5, generator=mask_generator(0, "cpu"))
    assert torch.equal(a, torch.randn(5, generator=mask_generator(0, "cpu")))
    assert not torch.equal(a, torch.randn(5, generator=mask_generator(1, "cpu")))
    assert not torch.equal(a, torch.randn(5, generator=torch.Generator().manual_seed(0)))
