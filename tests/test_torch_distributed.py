"""The port's sharded mixer (``repro_torch.core.distributed``) and the
trainer's multi-process path over ``torch.distributed``, on the CPU.

Each spawn starts W ranks of this file's ``__main__`` worker as
subprocesses (gloo, ``device="cpu"``, a free localhost port, a timeout,
the children killed on the way out); each rank runs every case of its
world in one process group and saves its rows, which the tests here
put together in rank order:

  * the shard bodies at W=2 and W=4 on N=8 rows of D=40 with some rows
    inactive: the ring (k=4: two shards; k=2; k=1 at N=4), the dense
    ``allgather``, ``psum`` and ``masked`` schedules, the sparse
    allgather and the ``gather`` schedule, each against the JAX
    package's ``gossip_mix_tree`` / ``gossip_mix_sparse_tree`` and the
    port's tree mixer on the same numpy inputs (``rtol=2e-5,
    atol=1e-5``, the JAX tests' tolerance), inactive rows bitwise;
  * the trainer at W=2 (N=8, H=8, SGD, 6 rounds, an eval every 2) with
    every schedule, DP off and at sigma=0.05, against the port's
    one-process tree run from the same generator seed: the population's
    L2 difference < 1e-4 and the losses within 1e-4 (the bounds of the
    JAX package's ``test_sharded_mixer_trains_like_tree_mixer``); both
    ranks' histories bitwise equal; masked bitwise allgather;
  * the same trainer from the JAX package's init and JAX-drawn
    ``RoundDraws`` against the JAX tree trainer (its sharded trainer's
    tests do not run on this box), within the same bounds;
  * the refusals at W > 1: N % W != 0, ``engine="loop"``, a tree mixer.

In process: W=1 sharded training is bitwise the tree mixer for every
schedule, the port's plan resolves the JAX package's cells with its
``sweep`` flags, and the grid forms fail in the JAX package's words
(the swept-sharded engine itself: ``tests/test_torch_sweep_sharded.py``).
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JaxFLConfig
from repro.core import GluADFL as JaxGluADFL
from repro.core.gossip import gossip_mix_sparse_tree as jax_sparse_tree
from repro.core.gossip import gossip_mix_tree as jax_tree
from repro.core.gossip_plan import supported_cells as jax_supported_cells
from repro.models import LSTMModel as JaxLSTM
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.config import FLConfig
from repro_torch.core import GluADFL, gossip_plan
from repro_torch.core.distributed import (
    make_sharded_gossip,
    sharded_gossip_mix,
    sharded_gossip_mix_gather,
    sharded_gossip_mix_sparse,
)
from repro_torch.core.gossip import gossip_mix_sparse_tree, gossip_mix_tree
from repro_torch.core.topology import mixing_matrix, neighbor_table, random_adjacency, ring_adjacency
from repro_torch.launch.mesh import make_federation_mesh
from repro_torch.models import LSTMModel
from repro_torch.optim import get_optimizer
from repro_torch.utils.rng import RoundDraws
from test_torch_train import _data, _flat, jax_draws

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-5, 1e-5          # the JAX package's sharded-gossip tests
POP_L2, LOSS_TOL = 1e-4, 1e-4    # the JAX package's sharded-trainer test
SPAWN_TIMEOUT = 120

# ------------------------------------------------------------ the spawn


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(script: Path, world: int, out: Path, timeout: float = SPAWN_TIMEOUT) -> None:
    """Run ``script``'s worker as ``world`` gloo ranks on a free port,
    each with ``--rank r --world W --port P --out out``; wait up to
    ``timeout`` seconds for all of them, kill what is left, and fail
    with the output of any rank that did not exit 0."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES", "REPRO_PROCESS_ID"):
        env.pop(k, None)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(script), "--rank", str(r), "--world",
                               str(world), "--port", str(port), "--out", str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (o, e)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}/{world} rc={p.returncode}\n{o[-2000:]}\n{e[-4000:]}"


def worker_args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", type=Path, required=True)
    return ap.parse_args(argv)


def rank_results(out: Path, world: int) -> list[dict]:
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------ the inputs

N, D, B = 8, 40, 3
ACTIVE = np.array([1, 0, 1, 1, 0, 1, 1, 0], np.float32)


def op_inputs(n: int = N):
    """``w`` (n, D), the activity flags and one random topology's dense
    matrix and (n, B+1) table, from one numpy seed."""
    rng = np.random.default_rng(n)
    w = rng.normal(size=(n, D)).astype(np.float32)
    active = torch.from_numpy(ACTIVE[:n].copy())
    adj = random_adjacency(torch.from_numpy(rng.uniform(size=(n, n)).astype(np.float32)), B)
    return torch.from_numpy(w), active, mixing_matrix(adj, active, B), neighbor_table(adj, active, B)


# (case, N) of the shard bodies at each world size
OP_CASES = {2: [("ring", 8), ("allgather", 8), ("psum", 8), ("masked", 8), ("sparse", 8),
                ("gather", 8)],
            4: [("ring", 8), ("ring", 4), ("allgather", 8), ("psum", 8), ("masked", 8),
                ("sparse", 8), ("gather", 8)]}


def run_op(case: str, n: int, mesh) -> torch.Tensor:
    """This rank's rows of one sharded mix."""
    w, active, mix, (idx, wgt) = op_inputs(n)
    mine = w[mesh.rows]
    if case == "ring":
        return make_sharded_gossip(mesh, "ring")(mine, active)
    if case == "sparse":
        return sharded_gossip_mix_sparse(mine, idx, wgt, active, mesh=mesh)
    if case == "gather":
        return sharded_gossip_mix_gather(mine, idx, wgt, active, mesh=mesh)
    return sharded_gossip_mix(mine, mix, active, mesh=mesh, impl=case)


# the trainer's cells: (gossip_impl, gossip_repr, dp sigma)
TRAIN_CASES = [(impl, repr_, sigma)
               for repr_, impls in (("dense", ("allgather", "psum", "masked")),
                                    ("sparse", ("allgather", "psum", "masked", "gather")))
               for impl in impls for sigma in (0.0, 0.05)]
JAX_CASES = [("allgather", "dense", 0.0), ("psum", "dense", 0.05), ("gather", "sparse", 0.05)]
ROUNDS, BATCH, LR = 6, 8, 1e-2


def trainer(mixer, impl, repr_, sigma, n=N, **fl):
    return GluADFL(LSTMModel(hidden=8).as_model(), get_optimizer("sgd", LR),
                   FLConfig(num_nodes=n, topology="random", inactive_ratio=0.3, comm_batch=B,
                            **fl),
                   mixer=mixer, gossip_impl=impl, gossip_repr=repr_, dp_noise_sigma=sigma,
                   device="cpu")


# the Markov schedule reads every node's staleness (an all-gather of the
# ranks' rows); the data skew shifts each rank's rows by their own offsets
MARKOV_SKEW = dict(schedule="markov", data_skew=0.5)


def fed():
    x, y, counts = _data(N, seed=11)
    return x, y, counts, (x[:2].reshape(-1, x.shape[2]), y[:2].reshape(-1))


def train_seeded(tt: GluADFL):
    x, y, counts, val = fed()
    return tt.train(torch.Generator().manual_seed(4), x, y, counts, batch_size=BATCH,
                    rounds=ROUNDS, eval_every=2, val_data=val)


def jax_run(impl, repr_, sigma):
    """The JAX tree trainer's run, its init params and its draws."""
    x, y, counts, val = fed()
    jt = JaxGluADFL(JaxLSTM(hidden=8).as_model(), jax_get_optimizer("sgd", LR),
                    JaxFLConfig(num_nodes=N, topology="random", inactive_ratio=0.3, comm_batch=B),
                    mixer="tree", gossip_repr=repr_, dp_noise_sigma=sigma)
    key = jax.random.PRNGKey(9)
    jpop, jhist, _ = jt.train(key, x, y, counts, batch_size=BATCH, rounds=ROUNDS, eval_every=2,
                              val_data=val)
    init = jt.init(key)
    k, draws = init.key, []
    for _ in range(ROUNDS):
        k, d = jax_draws(k, N, counts, random_topology=True,
                         dp_like=init.params if sigma else None)
        draws.append(d)
    params = {kk: np.asarray(v) for kk, v in init.params.items()}
    return jpop, jhist, params, draws


# ------------------------------------------------------------ the worker


def worker(argv) -> None:
    """One rank: every case of its world, then its results to
    ``out/rank<r>.pt``."""
    torch.set_num_threads(1)
    args = worker_args(argv)
    from repro_torch.launch import multihost

    assert multihost.initialize(f"127.0.0.1:{args.port}", args.world, args.rank, device="cpu")
    res = {"ops": {}, "train": {}, "jax": {}, "refused": {}}
    for case, n in OP_CASES[args.world]:
        res["ops"][(case, n)] = run_op(case, n, make_federation_mesh(n))
    try:
        make_federation_mesh(N, device="cuda")
    except ValueError as e:
        res["refused"]["cuda-on-gloo"] = str(e)
    for n in (9, 226):
        if n % args.world:
            try:
                trainer("sharded", "allgather", "dense", 0.0, n=n)
            except ValueError as e:
                res["refused"][f"N={n}"] = str(e)
    if args.world == 2:
        for case in TRAIN_CASES:
            tt = trainer("sharded", *case)
            pop, hist, state = train_seeded(tt)
            res["train"][case] = (pop, hist, state.params, tt.mesh.rows)
        pop, hist, state = train_seeded(trainer("sharded", "gather", "sparse", 0.0,
                                                **MARKOV_SKEW))
        res["train"]["markov-skew"] = (pop, hist, state.params, state.staleness)
        jax_in = torch.load(args.out / "jax_inputs.pt", weights_only=False)
        x, y, counts, val = fed()
        for case in JAX_CASES:
            tt = trainer("sharded", *case)
            params, draws = jax_in[case]
            state = tt.shard_state(tt.state_from_params(params))
            pop, hist, _ = tt.train(None, x, y, counts, batch_size=BATCH, rounds=ROUNDS,
                                    eval_every=2, val_data=val, state=state, draws=draws)
            res["jax"][case] = (pop, hist)
        for name, mixer, engine, error in (("loop", "sharded", "loop", NotImplementedError),
                                           ("tree", "tree", "scan", ValueError)):
            try:
                trainer(mixer, "allgather", "dense", 0.0).train(
                    torch.Generator().manual_seed(0), *fed()[:3], batch_size=BATCH, rounds=1,
                    engine=engine)
            except error as e:
                res["refused"][name] = str(e)
    torch.save(res, args.out / f"rank{args.rank}.pt")
    multihost.barrier()
    multihost.shutdown()


# ------------------------------------------------------------ the spawns


@pytest.fixture(scope="module")
def jax_runs():
    return {case: jax_run(*case) for case in JAX_CASES}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_runs):
    """Both spawns' per-rank results: ``{2: [rank0, rank1], 4: [...]}``;
    the W=2 ranks train from the JAX runs' init and draws too."""
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"world{world}")
        if world == 2:
            torch.save({case: run[2:] for case, run in jax_runs.items()}, d / "jax_inputs.pt")
        spawn_ranks(Path(__file__), world, d)
        out[world] = rank_results(d, world)
    return out


def assembled(results: list[dict], key) -> np.ndarray:
    return torch.cat([r["ops"][key] for r in results]).numpy()


@pytest.mark.parametrize("world,case,n", [(w, c, n) for w, cases in OP_CASES.items()
                                          for c, n in cases],
                         ids=[f"W{w}-{c}-N{n}" for w, cases in OP_CASES.items() for c, n in cases])
def test_shard_bodies_match_jax_and_tree(worlds, world, case, n):
    w, active, mix, (idx, wgt) = op_inputs(n)
    got = assembled(worlds[world], (case, n))
    jw = {"w": jnp.asarray(w.numpy())}
    if case == "ring":
        ring_mix = mixing_matrix(ring_adjacency(n), active, 7)
        want = np.asarray(jax_tree(jw, jnp.asarray(ring_mix.numpy()))["w"])
        tree = gossip_mix_tree(w, ring_mix)
    elif case in ("sparse", "gather"):
        want = np.asarray(jax_sparse_tree(jw, jnp.asarray(idx.numpy()), jnp.asarray(wgt.numpy()),
                                          jnp.asarray(active.numpy()))["w"])
        tree = gossip_mix_sparse_tree(w, idx, wgt, active)
    else:
        want = np.asarray(jax_tree(jw, jnp.asarray(mix.numpy()))["w"])
        tree = gossip_mix_tree(w, mix)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, tree.numpy(), rtol=RTOL, atol=ATOL)
    inactive = active.numpy() == 0
    assert inactive.any() and (~inactive).any()
    np.testing.assert_array_equal(got[inactive], w.numpy()[inactive])


def _close_to(pop, hist, ref_pop, ref_hist):
    diff = sum(float(np.sum((np.asarray(pop[k]) - np.asarray(ref_pop[k])) ** 2)) for k in ref_pop)
    assert diff ** 0.5 < POP_L2
    assert [sorted(h) for h in hist] == [sorted(h) for h in ref_hist]
    for a, b in zip(hist, ref_hist):
        for k in b:
            assert abs(a[k] - b[k]) < LOSS_TOL, (k, a, b)


@pytest.mark.parametrize("impl,repr_,sigma", TRAIN_CASES,
                         ids=[f"{i}-{r}-dp{s}" for i, r, s in TRAIN_CASES])
def test_two_rank_training_matches_the_tree_mixer(worlds, impl, repr_, sigma):
    r0, r1 = (r["train"][(impl, repr_, sigma)] for r in worlds[2])
    assert r0[1] == r1[1]  # both ranks' histories, bitwise
    assert all(torch.equal(r0[0][k], r1[0][k]) for k in r0[0])
    assert (r0[3], r1[3]) == (slice(0, 4), slice(4, 8))
    pop, hist, state = train_seeded(trainer("tree", "allgather", repr_, sigma))
    _close_to(r0[0], r0[1], pop, hist)
    np.testing.assert_allclose(torch.cat([r0[2], r1[2]]).numpy(), state.params.numpy(),
                               rtol=RTOL, atol=ATOL)


def test_two_rank_markov_schedule_and_data_skew_match_the_tree_mixer(worlds):
    (p0, h0, w0, s0), (p1, h1, w1, s1) = (r["train"]["markov-skew"] for r in worlds[2])
    assert h0 == h1
    pop, hist, state = train_seeded(trainer("tree", "allgather", "sparse", 0.0, **MARKOV_SKEW))
    _close_to(p0, h0, pop, hist)
    np.testing.assert_allclose(torch.cat([w0, w1]).numpy(), state.params.numpy(),
                               rtol=RTOL, atol=ATOL)
    assert torch.equal(torch.cat([s0, s1]), state.staleness)
    assert bool((state.staleness > 0).any())


@pytest.mark.parametrize("repr_,sigma", [("dense", 0.0), ("dense", 0.05), ("sparse", 0.0),
                                         ("sparse", 0.05)])
def test_two_rank_masked_training_is_bitwise_allgather(worlds, repr_, sigma):
    for r in worlds[2]:
        masked, plain = (r["train"][(impl, repr_, sigma)] for impl in ("masked", "allgather"))
        assert masked[1] == plain[1]
        assert torch.equal(masked[2], plain[2])


@pytest.mark.parametrize("impl,repr_,sigma", JAX_CASES,
                         ids=[f"{i}-{r}-dp{s}" for i, r, s in JAX_CASES])
def test_two_rank_training_matches_jax_tree_trainer(worlds, jax_runs, impl, repr_, sigma):
    jpop, jhist, _, _ = jax_runs[(impl, repr_, sigma)]
    (p0, h0), (p1, h1) = (r["jax"][(impl, repr_, sigma)] for r in worlds[2])
    assert h0 == h1
    _close_to(p0, h0, jpop, jhist)


@pytest.mark.parametrize("world,n", [(2, 9), (4, 226)])
def test_rows_that_do_not_split_over_the_ranks_are_refused(worlds, world, n):
    for r in worlds[world]:
        msg = r["refused"][f"N={n}"]
        assert f"N={n}" in msg and f"W={world}" in msg


def test_loop_engine_and_tree_mixer_refused_over_two_ranks(worlds):
    for r in worlds[2]:
        assert "single-process" in r["refused"]["loop"]
        assert "mixer='sharded'" in r["refused"]["tree"]


@pytest.mark.parametrize("world", [2, 4])
def test_a_cuda_trainer_never_runs_on_a_gloo_group(worlds, world):
    for r in worlds[world]:
        assert "needs a 'nccl' process group, got 'gloo'" in r["refused"]["cuda-on-gloo"]


# ------------------------------------------------------------ in process


@pytest.mark.parametrize("impl,repr_", [("allgather", "dense"), ("psum", "dense"),
                                        ("masked", "dense"), ("allgather", "sparse"),
                                        ("psum", "sparse"), ("gather", "sparse")])
def test_one_rank_sharded_training_is_bitwise_tree(impl, repr_):
    for sigma in (0.0, 0.05):
        tt = trainer("sharded", impl, repr_, sigma)
        assert tt.mesh.width == 1 and tt.mesh.group is None
        pop, hist, state = train_seeded(tt)
        rpop, rhist, rstate = train_seeded(trainer("tree", "allgather", repr_, sigma))
        assert hist == rhist
        assert torch.equal(state.params, rstate.params)
        assert all(torch.equal(pop[k], rpop[k]) for k in pop)
        assert all(torch.equal(state.opt_state[k], rstate.opt_state[k])
                   for k in state.opt_state if state.opt_state[k] is not None)


def _cell_key(c):
    return (c["mixer"], c["gossip_impl"], c["gossip_repr"], c["backend"], c["multihost"])


def test_supported_cells_match_jax():
    """The port's registry resolves the JAX package's cells, to the same
    backends and multi-host capability."""
    ours, theirs = gossip_plan.supported_cells(), jax_supported_cells()
    assert sorted(map(_cell_key, ours)) == sorted(map(_cell_key, theirs))
    assert len(ours) == 19


def test_supported_cells_sweep_flags_match_jax():
    """Every cell of the port's registry has the JAX package's ``sweep``
    flag: the tree and sharded (allgather, psum, masked) backends batch
    a sweep grid, the kernel mixer and the gather tables do not, and
    the plan refuses those two in the JAX package's words."""
    jax_sweep = {_cell_key(c): c["sweep"] for c in jax_supported_cells()}
    ours = gossip_plan.supported_cells()
    assert {_cell_key(c): c["sweep"] for c in ours} == jax_sweep
    assert {c["backend"] for c in ours if c["sweep"]} == {"tree", "sharded"}
    gather = gossip_plan.resolve_gossip_plan(mixer="sharded", gossip_impl="gather",
                                             gossip_repr="sparse", num_nodes=8, comm_batch=2)
    with pytest.raises(NotImplementedError, match="gather tables"):
        gather.require_sweep()
    gossip_plan.resolve_gossip_plan(mixer="sharded", num_nodes=8, comm_batch=2).require_sweep()


def test_grid_forms_fail_in_jax_words():
    """The grid forms' shape errors are the JAX package's
    (``tests/test_distributed.py``'s
    ``test_sharded_gossip_mix_shape_mismatch_fails_at_trace`` on a
    one-device (1, 1) sweep mesh): a mismatched scenario grid says
    "leading dim", a 2-D operator with ``grid_axis`` says "mixing
    matrix" / "neighbor table"."""
    from repro_torch.launch.mesh import make_sweep_mesh

    mesh = make_sweep_mesh(3, 8, grid_width=1, node_width=1)
    w = torch.ones((3, 8, 4))
    eye = torch.eye(8)
    with pytest.raises(ValueError, match="leading dim"):
        sharded_gossip_mix(w, torch.stack([eye] * 4), mesh=mesh)
    with pytest.raises(ValueError, match="mixing matrix"):
        sharded_gossip_mix(w, eye, mesh=mesh, grid_axis="grid")
    idx = torch.arange(8)[:, None].expand(8, 3).contiguous()
    wgt = torch.full((8, 3), 1 / 3)
    for fn in (sharded_gossip_mix_sparse, sharded_gossip_mix_gather):
        with pytest.raises(ValueError, match="leading dim"):
            fn(w, torch.stack([idx] * 2), torch.stack([wgt] * 2), mesh=mesh)
        with pytest.raises(ValueError, match="neighbor table"):
            fn(w, idx, wgt, mesh=mesh, grid_axis="grid")
    w2, _, mix, _ = op_inputs()
    with pytest.raises(ValueError, match="sparse-only"):
        sharded_gossip_mix(w2, mix, impl="gather")


if __name__ == "__main__":
    worker(sys.argv[1:])
