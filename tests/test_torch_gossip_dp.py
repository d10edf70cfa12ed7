"""Gossip data-parallelism in the port (``repro_torch.core.gossip_dp``
and ``launch.mesh.make_gossip_dp_mesh``) on the CPU.

  * ``GossipDPSchedule``, bernoulli and markov, given JAX-drawn scores
    and activity uniforms in JAX's split order (``key, k_top, k_act =
    split(key, 3)`` a mix): every mixing matrix the JAX package's
    bitwise, the markov chain carried across mixes; its cadence
    (``should_mix``) as ``tests/test_gossip_dp.py`` and
    ``tests/test_distributed.py`` pin it; its own draws row-stochastic.
  * ``gossip_mix_params`` (``allgather``, ``masked``, ``psum``) and
    ``ring_mix_params`` over gloo ranks (W = 2 and 4, spawned as this
    file's ``__main__`` worker, as ``tests/test_torch_distributed.py``
    spawns its ranks) on the mesh layouts (node, data, model) = (2, 1, 1),
    (4, 1, 1) and (2, 2, 1), and across two pods (pod, node, data,
    model) = (2, 1, 2, 1) over the compound ``("pod", "node")`` axes:
    every rank's result within 1e-6 of the dense oracle sum_m M[n, m]
    w_m of its node n (the JAX package's own tests of these are
    ``multidevice`` tests; the oracle is their yardstick too); the ring
    against ``mixing_matrix(ring_adjacency(N), ones, 2) @ w``, the N = 2
    average included; the node subgroups' members and node indices.
  * W = 1 (no process group): every mix the identity, bitwise; the
    ``specs`` leaf-count ``ValueError``; an unknown ``impl``; a mesh
    that does not cover the ranks.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.gossip_dp import (GossipDPSchedule, gossip_mix_params, node_count,
                                        ring_mix_params)
from repro_torch.core.topology import mixing_matrix, random_adjacency, ring_adjacency
from repro_torch.launch.mesh import make_gossip_dp_mesh

HERE = Path(__file__).resolve()
ORACLE_TOL = 1e-6
# the layouts a world runs: (make_gossip_dp_mesh kwargs, node axes)
LAYOUTS = {
    2: [(dict(nodes=2, data=1, model=1), ("node",))],
    4: [(dict(nodes=4, data=1, model=1), ("node",)),
        (dict(nodes=2, data=2, model=1), ("node",)),
        (dict(nodes=2, multi_pod=True, data=2, model=1), ("pod", "node"))],
}
IMPLS = ("allgather", "masked", "psum")


def _base(n: int, seed: int) -> dict:
    """Node-varying params: leaf (N, ...) as numpy, row n node n's."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(n, 6, 5)).astype(np.float32),
            "b": [rng.normal(size=(n, 3)).astype(np.float32)]}


def _mix(n: int, seed: int) -> torch.Tensor:
    """A random topology's mixing matrix over n nodes, node 1 inactive
    from n = 4."""
    gen = torch.Generator().manual_seed(seed)
    active = torch.ones(n)
    if n >= 4:
        active[1] = 0.0
    adj = random_adjacency(torch.rand((n, n), generator=gen), min(2, n - 1))
    return mixing_matrix(adj, active, 2)


def _node_params(base: dict, idx: int) -> dict:
    return {"w": torch.tensor(base["w"][idx]), "b": [torch.tensor(base["b"][0][idx])]}


# ------------------------------------------------------------ the worker


def worker(argv) -> None:
    import torch.distributed as dist

    ap = argparse.ArgumentParser()
    for flag in ("--rank", "--world", "--port"):
        ap.add_argument(flag, type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.world, rank=args.rank)
    torch.set_num_threads(1)
    results = []
    for case, (kw, axes) in enumerate(LAYOUTS[args.world]):
        mesh = make_gossip_dp_mesh(device="cpu", **kw)
        n, idx = node_count(mesh, axes), mesh.node_index(axes)
        group = mesh.node_group(axes)
        base, mix = _base(n, case), _mix(n, case)
        params = _node_params(base, idx)
        row = {"shape": mesh.shape, "coords": mesh.coords, "idx": idx, "n": n,
               "members": [dist.get_global_rank(group, r) for r in range(n)],
               "ring": ring_mix_params(params, mesh, axes, specs={"w": None, "b": [None]})}
        for impl in IMPLS:
            row[impl] = gossip_mix_params(params, mix, mesh, axes, impl=impl)
        results.append(row)
    torch.save(results, args.out / f"rank{args.rank}.pt")
    dist.destroy_process_group()


# ------------------------------------------------------------ the tests


def _oracle(mix: np.ndarray, leaf: np.ndarray) -> np.ndarray:
    return np.einsum("nm,m...->n...", mix.astype(np.float64), leaf.astype(np.float64))


@pytest.mark.parametrize("world", [2, 4])
def test_mixes_over_gloo_ranks_match_the_dense_oracle(world, tmp_path):
    from test_torch_distributed import spawn_ranks

    spawn_ranks(HERE, world, tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
    for case, (kw, axes) in enumerate(LAYOUTS[world]):
        rows = [results[case] for results in ranks]
        n, widths = rows[0]["n"], rows[0]["shape"]
        pods = {"pod": 2, "node": kw["nodes"] // 2} if kw.get("multi_pod") else {}
        assert widths == {"node": kw["nodes"], **pods, "data": kw["data"], "model": kw["model"]}
        assert list(widths) == (["pod"] if pods else []) + ["node", "data", "model"]
        assert n == int(np.prod([widths[a] for a in axes]))
        base, mix = _base(n, case), _mix(n, case).numpy()
        ring = mixing_matrix(ring_adjacency(n), torch.ones(n), 2).numpy()
        for rank, row in enumerate(rows):
            # row-major coordinates; the subgroup: the ranks that differ from
            # this one only on the node axes, in node order
            assert row["coords"] == tuple(np.unravel_index(rank, tuple(widths.values())))
            coord = dict(zip(widths, row["coords"]))
            idx = 0
            for a in axes:
                idx = idx * widths[a] + coord[a]
            assert row["idx"] == idx
            assert row["members"] == sorted(row["members"]) and row["members"][idx] == rank
            for member in row["members"]:
                other = dict(zip(widths, np.unravel_index(member, tuple(widths.values()))))
                assert all(other[a] == coord[a] for a in widths if a not in axes)
            for impl in IMPLS + ("ring",):
                m = ring if impl == "ring" else mix
                got = row[impl]
                for want, leaf in ((_oracle(m, base["w"])[idx], got["w"]),
                                   (_oracle(m, base["b"][0])[idx], got["b"][0])):
                    assert leaf.dtype == torch.float32
                    np.testing.assert_allclose(leaf.numpy(), want, rtol=0, atol=ORACLE_TOL,
                                               err_msg=f"W={world} {kw} {impl} rank {rank}")
        if n >= 4:  # inactive node 1 keeps its params (an identity row)
            holder = next(row for row in rows if row["idx"] == 1)
            for impl in IMPLS:
                np.testing.assert_allclose(holder[impl]["w"].numpy(), base["w"][1], atol=0)


def test_one_process_mixes_are_the_identity_bitwise():
    mesh = make_gossip_dp_mesh(nodes=1, data=1, model=1)
    assert mesh.shape == {"node": 1, "data": 1, "model": 1}
    assert node_count(mesh, ("node",)) == 1 and mesh.node_group(("node",)) is None
    params = _node_params(_base(1, 0), 0)
    mix = mixing_matrix(ring_adjacency(1), torch.ones(1), 2)
    assert torch.equal(mix, torch.ones((1, 1)))
    for impl in IMPLS:
        out = gossip_mix_params(params, mix, mesh, ("node",), impl=impl)
        assert torch.equal(out["w"], params["w"]) and torch.equal(out["b"][0], params["b"][0])
    out = ring_mix_params(params, mesh, ("node",))
    assert torch.equal(out["w"], params["w"]) and torch.equal(out["b"][0], params["b"][0])
    with pytest.raises(ValueError, match="impl"):
        gossip_mix_params(params, mix, mesh, ("node",), impl="gather")


def test_ring_mix_specs_leaf_mismatch_raises():
    """A specs tree of another leaf count refuses loudly, as JAX's does
    (``tests/test_gossip_dp.py``)."""
    mesh = make_gossip_dp_mesh(nodes=1, data=1, model=1)
    params = {"a": torch.ones(4), "b": torch.ones(4)}
    with pytest.raises(ValueError, match="leaves"):
        ring_mix_params(params, mesh, ("node",), specs={"a": None})
    assert ring_mix_params(params, mesh, ("node",), specs={"a": None, "b": None}) is params


def test_gossip_dp_mesh_refuses_widths_that_do_not_cover_the_ranks():
    with pytest.raises(ValueError, match="W=1"):
        make_gossip_dp_mesh()  # JAX's 16-wide split: 256 ranks a pod
    with pytest.raises(ValueError, match="W=1"):
        make_gossip_dp_mesh(nodes=2, multi_pod=True, data=1, model=1)  # two pods


@pytest.mark.parametrize("schedule,topology", [("bernoulli", "random"), ("markov", "random"),
                                               ("bernoulli", "ring")])
def test_schedule_mixes_equal_jax_given_its_draws(schedule, topology):
    import jax

    from repro.core.gossip_dp import GossipDPSchedule as JaxSchedule

    kw = dict(comm_batch=3, mix_every=2, inactive_ratio=0.3, seed=5, schedule=schedule)
    theirs, mine = JaxSchedule(topology, 8, **kw), GossipDPSchedule(topology, 8, **kw,
                                                                    device="cpu")
    key = jax.random.PRNGKey(5)
    for _ in range(4):
        key, k_top, k_act = jax.random.split(key, 3)
        scores = torch.tensor(np.asarray(jax.random.uniform(k_top, (8, 8))))
        u_act = torch.tensor(np.asarray(jax.random.uniform(k_act, (8,))))
        want = np.asarray(theirs.next_mix())
        got = mine.next_mix(scores=scores, u_act=u_act)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(mine.prev_active.numpy(), np.asarray(theirs.prev_active))
    assert [mine.should_mix(s) for s in range(6)] == [theirs.should_mix(s) for s in range(6)]


def test_schedule_cadence_and_its_own_draws(monkeypatch):
    cpu = dict(device="cpu")
    assert [GossipDPSchedule("ring", 4, mix_every=3, **cpu).should_mix(t)
            for t in range(6)] == [False, False, True, False, False, True]
    sched = GossipDPSchedule("random", 8, comm_batch=3, mix_every=4, inactive_ratio=0.3, **cpu)
    assert [sched.should_mix(s) for s in range(8)] == [False, False, False, True] * 2
    m1, m2 = sched.next_mix(), sched.next_mix()
    assert m1.shape == (8, 8) and not torch.equal(m1, m2)  # time-varying
    torch.testing.assert_close(m1.sum(dim=1), torch.ones(8), rtol=0, atol=1e-6)
    again = GossipDPSchedule("random", 8, comm_batch=3, mix_every=4, inactive_ratio=0.3, **cpu)
    assert torch.equal(again.next_mix(), m1)  # the seed replays the schedule
    with pytest.raises(ValueError, match="schedule"):
        GossipDPSchedule("ring", 4, schedule="poisson", **cpu)
    # the port's entry points run on CUDA unless the CPU is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GossipDPSchedule("ring", 4)


if __name__ == "__main__":
    worker(sys.argv[1:])
