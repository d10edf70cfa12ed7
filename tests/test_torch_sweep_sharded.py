"""The port's swept-sharded engine (``train_sweep`` with
``mixer="sharded"`` on a ``(grid_width, node_width)`` layout of ranks),
on the CPU over gloo.

Spawns (``test_torch_distributed.spawn_ranks``: gloo, a free localhost
port, a timeout) start W = 1, 2 and 4 ranks of this file's ``__main__``
worker; each rank runs every case of its world and saves its block,
which the tests put together by ``r = gi · node_width + ni``:

  * the grid forms at (2, 2) (W=4) against the JAX package's on a
    forced-4-device ``(2, 2)`` sweep mesh in a subprocess, on G=4
    scenarios of N=8 rows of D=40 (dense bitwise for allgather and
    masked, psum within 1e-6 relative; sparse and gather within 1e-6:
    XLA sums a row's B+1 products in another order than torch's einsum,
    one ulp apart at (1, 1)), each running one collective a round for
    the rank's whole block;
  * the trainer on the Fig-5-like grid (ring, random) x inactive (0,
    0.4), G=4, N=8, H=8, Adam, 6 rounds in chunks of 4 with an eval
    every 2, on (1, 1) of a one-rank group, (1, 2), (2, 1) and (2, 2):
    each scenario against the port's serial sharded ``train`` on the
    rank's node subgroup from the same seed (bitwise), and against the
    port's one-process tree sweep (bitwise at node width 1; else the
    bounds of ``tests/test_torch_distributed.py``: rows within
    ``rtol=2e-5, atol=1e-5``, populations within an L2 of 1e-4, losses
    and val records within 1e-4); every rank's histories and
    populations bitwise the same; masked bitwise allgather;
  * at (2, 2), from the JAX package's init and JAX-drawn draws, against
    JAX's tree ``train_sweep`` (SGD: ``tests/test_torch_sweep.py``'s
    bounds; JAX's own swept-sharded trainer does not run on this box's
    jax);
  * the CLI ``--mixer sharded --num-processes 2`` sweep against the
    one-process tree sweep, rank 0 alone writing the summary;
  * the refusals: widths that leave ranks out, a CUDA mesh on gloo.

In process: the width search against JAX's, ``make_sweep_mesh``'s
refusals, the grid forms at (1, 1) against JAX's, the one-process
trainer bitwise the tree sweep, and the one-process CLI (the grid
forms' shape errors: ``tests/test_torch_distributed.py``).
"""
from __future__ import annotations

import contextlib
import io
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as JaxFLConfig
from repro.core import GluADFL as JaxGluADFL
from repro.core import SweepGrid as JaxSweepGrid
from repro.core.distributed import sharded_gossip_mix as jax_mix
from repro.core.distributed import sharded_gossip_mix_gather as jax_mix_gather
from repro.core.distributed import sharded_gossip_mix_sparse as jax_mix_sparse
from repro.launch.mesh import _sweep_mesh_widths as jax_widths
from repro.launch.mesh import make_sweep_mesh as jax_sweep_mesh
from repro.models import LSTMModel as JaxLSTM
from repro.optim import get_optimizer as jax_get_optimizer
from repro_torch.config import FLConfig
from repro_torch.core import GluADFL, SweepGrid
from repro_torch.core.distributed import (
    sharded_gossip_mix,
    sharded_gossip_mix_gather,
    sharded_gossip_mix_sparse,
)
from repro_torch.core.topology import mixing_matrix, neighbor_table, random_adjacency
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import _sweep_mesh_widths, make_sweep_mesh
from repro_torch.models import LSTMModel
from repro_torch.optim import get_optimizer
from test_torch_distributed import (
    ATOL,
    LOSS_TOL,
    POP_L2,
    RTOL,
    rank_results,
    spawn_ranks,
    worker_args,
)
from test_torch_sweep import jax_sweep_draws, toy_fed, val_set

ROOT = Path(__file__).resolve().parents[1]
G, N, D, B, H = 4, 8, 40, 3, 8
GRID_TOL = 1e-6
ROUNDS, CHUNK, EVAL_EVERY, BATCH = 6, 4, 2, 8
TOPOLOGIES, RATIOS = ("ring", "random"), (0.0, 0.4)
# the layouts of each world: (grid_width, node_width)
LAYOUTS = {1: [(1, 1)], 2: [(1, 2), (2, 1)], 4: [(2, 2)]}
# the trainer's cells: (gossip_impl, gossip_repr, armed axes)
DP = {"dp_sigmas": (0.05,)}
AXES = {"schedules": ("bernoulli", "markov"), "skews": (0.0, 0.5)}
TRAIN_CASES = [("allgather", "dense", {}), ("psum", "dense", DP), ("masked", "dense", {}),
               ("allgather", "sparse", DP), ("psum", "sparse", {}), ("masked", "sparse", DP),
               ("allgather", "sparse", AXES)]
JAX_CASE = ("psum", "dense")
CLI_BASE = ["--device", "cpu", "--fast-data", "--rounds", "3", "--hidden", "8", "--eval-every",
            "2", "--topology", "random", "--sweep-ratios", "0,0.5", "--sweep-seeds", "2"]


def case_id(case) -> str:
    impl, repr_, axes = case
    return f"{impl}-{repr_}" + ("-dp" if axes is DP else "-axes" if axes is AXES else "")


# ------------------------------------------------------------ the inputs


def op_inputs():
    """The grid forms' inputs: w (G, N, D), the (G, N) flags and each
    scenario's random topology as (G, N, N) matrices and (G, N, B+1)
    tables, from one numpy seed."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(G, N, D)).astype(np.float32)
    active = (rng.uniform(size=(G, N)) > 0.35).astype(np.float32)
    adj = random_adjacency(torch.from_numpy(rng.uniform(size=(G, N, N)).astype(np.float32)), B)
    act = torch.from_numpy(active)
    return torch.from_numpy(w), act, mixing_matrix(adj, act, B), neighbor_table(adj, act, B)


FORMS = ("allgather", "psum", "masked", "sparse", "gather")


def port_form(form, w, active, mix, table, mesh):
    if form == "sparse":
        return sharded_gossip_mix_sparse(w, *table, active, mesh=mesh)
    if form == "gather":
        return sharded_gossip_mix_gather(w, *table, active, mesh=mesh)
    return sharded_gossip_mix(w, mix, active, mesh=mesh, impl=form)


def grid(axes=None) -> SweepGrid:
    return SweepGrid.build(TOPOLOGIES if axes is not AXES else ("random",),
                           RATIOS if axes is not AXES else (0.4,), (0,), num_nodes=N,
                           **(axes or {}))


def trainer(mixer, impl, repr_, *, opt="adam", lr=1e-2, mesh=None, sigma=0.0, **fl):
    return GluADFL(LSTMModel(hidden=H).as_model(), get_optimizer(opt, lr),
                   FLConfig(num_nodes=N, comm_batch=B, **fl), mixer=mixer, gossip_impl=impl,
                   gossip_repr=repr_, dp_noise_sigma=sigma, mesh=mesh, device="cpu")


def fed():
    return (*toy_fed(n=N), val_set())


def sweep(t, g, **kw):
    x, y, counts, val = fed()
    return t.train_sweep(x, y, counts, grid=g, batch_size=BATCH, rounds=ROUNDS, chunk=CHUNK,
                         eval_every=EVAL_EVERY, val_data=val, **kw)


def serial(g: SweepGrid, s: int, impl, repr_, mesh):
    """Scenario s of ``g`` as the port's serial sharded ``train`` on the
    federation mesh ``mesh`` (a node subgroup) from its seed."""
    lab = g.label_dict(s)
    t = trainer("sharded", impl, repr_, mesh=mesh, sigma=lab["dp_sigma"],
                topology=lab["topology"], inactive_ratio=lab["inactive_ratio"],
                schedule=lab["schedule"], data_skew=lab["skew"])
    x, y, counts, val = fed()
    return t.train(torch.Generator().manual_seed(lab["seed"]), x, y, counts, batch_size=BATCH,
                   rounds=ROUNDS, chunk=CHUNK, eval_every=EVAL_EVERY, val_data=val)


def jax_grids():
    return (JaxSweepGrid.build(TOPOLOGIES, RATIOS, (0,), num_nodes=N),
            SweepGrid.build(TOPOLOGIES, RATIOS, (0,), num_nodes=N))


def jax_sweep():
    """JAX's tree ``train_sweep`` (SGD), its init params and its draws."""
    x, y, counts, val = fed()
    jgrid, _ = jax_grids()
    jt = JaxGluADFL(JaxLSTM(hidden=H).as_model(), jax_get_optimizer("sgd", 1e-2),
                    JaxFLConfig(num_nodes=N, comm_batch=B), gossip_repr=JAX_CASE[1])
    out = jt.train_sweep(x, y, counts, grid=jgrid, batch_size=BATCH, rounds=ROUNDS, chunk=CHUNK,
                         eval_every=EVAL_EVERY, val_data=val)
    init = jt._sweep_init_jit(jgrid.init_keys)
    draws = list(jax_sweep_draws(init.key, jgrid, counts, ROUNDS))
    return out, {k: np.asarray(v) for k, v in init.params.items()}, draws


# ------------------------------------------------------------ the worker


def counting_collectives(calls: Counter):
    """Count every collective by (name, group)."""
    dist = torch.distributed
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor", "batch_isend_irecv",
                 "all_reduce"):
        orig = getattr(dist, name)

        def wrapped(*a, _orig=orig, _name=name, **kw):
            group = a[0][0].group if _name == "batch_isend_irecv" else kw.get("group")
            calls[(_name, group)] += 1
            return _orig(*a, **kw)
        setattr(dist, name, wrapped)


def worker(argv) -> None:
    torch.set_num_threads(1)
    args = worker_args(argv)
    from repro_torch.launch import multihost

    if args.world == 1:   # a one-rank group, as the card's one NCCL rank
        torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{args.port}",
                                             world_size=1, rank=0)
    else:
        assert multihost.initialize(f"127.0.0.1:{args.port}", args.world, args.rank,
                                    device="cpu")
    calls: Counter = Counter()
    counting_collectives(calls)
    res = {"forms": {}, "collectives": {}, "train": {}, "serial": {}, "jax": None, "cli": None,
           "refused": {}, "layouts": {}}
    for layout in LAYOUTS[args.world]:
        mesh = make_sweep_mesh(G, N, grid_width=layout[0], node_width=layout[1], device="cpu")
        node_group = mesh.node.group
        res["layouts"][layout] = (mesh.grid_index, mesh.node.rank, mesh.scenarios(G), mesh.rows)
        if layout == (2, 2):
            w, active, mix, table = op_inputs()
            sc, rows = mesh.scenarios(G), mesh.rows
            for form in FORMS:
                calls.clear()
                res["forms"][form] = port_form(form, w[sc, rows], active[sc], mix[sc],
                                               tuple(t[sc] for t in table), mesh)
                res["collectives"][form] = {name: n for (name, group), n in calls.items()
                                            if group is node_group}
        for case in TRAIN_CASES:
            impl, repr_, axes = case
            g = grid(axes)
            calls.clear()
            pops, hists, states = sweep(trainer("sharded", impl, repr_, mesh=mesh), g)
            gossip = {name: n for (name, group), n in calls.items()
                      if group is node_group and name != "all_reduce"}
            res["train"][(layout, case_id(case))] = (pops, hists, states, gossip)
            for s in range(G)[mesh.scenarios(G)]:
                pop, hist, state = serial(g, s, impl, repr_, mesh.node)
                res["serial"][(layout, case_id(case), s)] = (pop, hist, state)
        if layout == (2, 2):
            jax_in = torch.load(args.out / "jax_inputs.pt", weights_only=False)
            t = trainer("sharded", *JAX_CASE, opt="sgd", mesh=mesh)
            _, g = jax_grids()
            res["jax"] = sweep(t, g, states=t.state_from_params(jax_in["params"]),
                               draws=jax_in["draws"])
    if args.world == 2:
        out = args.out / f"cli{args.rank}"
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = train_cli.run(CLI_BASE + ["--mixer", "sharded", "--num-processes", "2",
                                            "--process-id", str(args.rank), "--coordinator",
                                            f"127.0.0.1:{args.port}", "--out", str(out)])
        res["cli"] = (run.history, run.population, run.checkpoint, run.trainer.mesh.shape,
                      sorted(p.name for p in out.glob("*")) if out.exists() else [],
                      printed.getvalue())
        for name, call in (("cover", lambda: make_sweep_mesh(G, N, grid_width=1, node_width=1)),
                           ("search", lambda: make_sweep_mesh(7, 13)),
                           ("cuda", lambda: make_sweep_mesh(G, N, device="cuda"))):
            try:
                call()
            except ValueError as e:
                res["refused"][name] = str(e)
    torch.save(res, args.out / f"rank{args.rank}.pt")
    multihost.barrier()
    multihost.shutdown()


# ------------------------------------------------------------ the spawns


JAX_GRID_SCRIPT = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.core.distributed import (sharded_gossip_mix, sharded_gossip_mix_gather,
                                    sharded_gossip_mix_sparse)
from repro.launch.mesh import make_sweep_mesh
inp = np.load(sys.argv[1])
mesh = make_sweep_mesh(4, 8, grid_width=2, node_width=2)
assert dict(mesh.shape) == {"grid": 2, "node": 2}
w = {"w": jnp.asarray(inp["w"])}
active, mix = jnp.asarray(inp["active"]), jnp.asarray(inp["mix"])
idx, wgt = jnp.asarray(inp["idx"]), jnp.asarray(inp["wgt"])
out = {f: np.asarray(sharded_gossip_mix(w, mix, active, mesh=mesh, impl=f)["w"])
       for f in ("allgather", "psum", "masked")}
out["sparse"] = np.asarray(sharded_gossip_mix_sparse(w, idx, wgt, active, mesh=mesh)["w"])
out["gather"] = np.asarray(sharded_gossip_mix_gather(w, idx, wgt, active, mesh=mesh)["w"])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def jax_forms(tmp_path_factory):
    """The JAX package's grid forms on a forced-4-device (2, 2) sweep mesh."""
    d = tmp_path_factory.mktemp("jaxgrid")
    w, active, mix, (idx, wgt) = op_inputs()
    np.savez(d / "in.npz", w=w.numpy(), active=active.numpy(), mix=mix.numpy(), idx=idx.numpy(),
             wgt=wgt.numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", JAX_GRID_SCRIPT, str(d / "in.npz"),
                           str(d / "out.npz")], env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(d / "out.npz"))


@pytest.fixture(scope="module")
def jax_run():
    return jax_sweep()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, jax_run):
    out = {}
    for world in (1, 2, 4):
        d = tmp_path_factory.mktemp(f"sweep{world}")
        if world == 4:
            _, params, draws = jax_run
            torch.save({"params": params, "draws": draws}, d / "jax_inputs.pt")
        spawn_ranks(Path(__file__), world, d, timeout=240)
        out[world] = rank_results(d, world)
    return out


@pytest.fixture(scope="module")
def tree_sweeps():
    """The port's one-process tree sweep of every trainer case."""
    return {case_id(c): sweep(trainer("tree", c[0], c[1]), grid(c[2])) for c in TRAIN_CASES}


def assemble(results, layout, pick):
    """The (G, N, ...) whole of every rank's (Gb, k, ...) block."""
    gw, nw = layout
    blocks = [pick(r) for r in results]
    return torch.cat([torch.cat(blocks[gi * nw:(gi + 1) * nw], dim=1) for gi in range(gw)])


# ------------------------------------------------------------ mesh


@pytest.mark.parametrize("avail", range(1, 9))
def test_sweep_mesh_widths_match_jax(avail):
    for g in range(1, 17):
        for n in range(1, 33):
            assert _sweep_mesh_widths(g, n, avail) == jax_widths(g, n, avail), (g, n, avail)
    # the JAX package's own cases (tests/test_launch_utils.py)
    assert _sweep_mesh_widths(15, 32, 8) == (1, 8)
    assert _sweep_mesh_widths(4, 6, 8) == (4, 2)
    assert _sweep_mesh_widths(4, 4, 8) == (2, 4)
    assert _sweep_mesh_widths(7, 13, 4) == (1, 1)
    assert _sweep_mesh_widths(15, 226, 1) == (1, 1)


def test_one_process_sweep_mesh_and_refusals():
    mesh = make_sweep_mesh(15, 226, device="cpu")
    assert mesh.axis_names == ("grid", "node") and mesh.shape == {"grid": 1, "node": 1}
    assert (mesh.node.group, mesh.grid_group, mesh.rows, mesh.scenarios(15)) == (
        None, None, slice(0, 226), slice(0, 15))
    with pytest.raises(ValueError, match="divide"):
        make_sweep_mesh(15, 32, grid_width=2, node_width=1)
    with pytest.raises(ValueError, match=r"G=4 .*N=8 .*W=1"):
        make_sweep_mesh(4, 8, grid_width=2, node_width=2)


def test_multi_rank_sweep_mesh_refusals(worlds):
    for r in worlds[2]:
        assert "W=2" in r["refused"]["cover"] and "G=4" in r["refused"]["cover"]
        assert "G=7" in r["refused"]["search"] and "N=13" in r["refused"]["search"]
        assert "needs a 'nccl' process group, got 'gloo'" in r["refused"]["cuda"]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_take_the_row_major_layout(worlds, world):
    for r, res in enumerate(worlds[world]):
        for (gw, nw), (gi, ni, sc, rows) in res["layouts"].items():
            assert (gi, ni) == divmod(r, nw)
            assert sc == slice(gi * G // gw, (gi + 1) * G // gw)
            assert rows == slice(ni * N // nw, (ni + 1) * N // nw)


# ------------------------------------------------------------ grid forms


@pytest.mark.parametrize("form", FORMS)
def test_grid_forms_at_one_by_one_match_jax(form):
    w, active, mix, table = op_inputs()
    got = port_form(form, w, active, mix, table, make_sweep_mesh(G, N))
    jmesh = jax_sweep_mesh(G, N, grid_width=1, node_width=1)
    jw = {"w": jax.numpy.asarray(w.numpy())}
    ja = jax.numpy.asarray(active.numpy())
    if form in ("sparse", "gather"):
        fn = jax_mix_sparse if form == "sparse" else jax_mix_gather
        want = fn(jw, *(jax.numpy.asarray(t.numpy()) for t in table), ja, mesh=jmesh)["w"]
    else:
        want = jax_mix(jw, jax.numpy.asarray(mix.numpy()), ja, mesh=jmesh, impl=form)["w"]
    want = np.asarray(want)
    if form in ("allgather", "masked", "psum"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=GRID_TOL)
    inactive = active.numpy() == 0
    np.testing.assert_array_equal(got.numpy()[inactive], w.numpy()[inactive])
    # the flat (Gb·k, D) rows give the same block
    flat = port_form(form, w.reshape(G * N, D), active, mix, table, make_sweep_mesh(G, N))
    assert torch.equal(flat.view(G, N, D), got)


@pytest.mark.parametrize("form", FORMS)
def test_grid_forms_at_two_by_two_match_jax(worlds, jax_forms, form):
    got = assemble(worlds[4], (2, 2), lambda r: r["forms"][form]).numpy()
    want = jax_forms[form]
    if form in ("allgather", "masked"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=GRID_TOL, atol=GRID_TOL)
    w, active, _, _ = op_inputs()
    inactive = active.numpy() == 0
    np.testing.assert_array_equal(got[inactive], w.numpy()[inactive])


@pytest.mark.parametrize("form,want", [("allgather", {"all_gather_into_tensor": 1}),
                                       ("psum", {"reduce_scatter_tensor": 1}),
                                       ("masked", {"all_gather_into_tensor": 1}),
                                       ("sparse", {"all_gather_into_tensor": 1}),
                                       ("gather", {"batch_isend_irecv": 1})])
def test_grid_forms_run_one_collective_for_the_whole_block(worlds, form, want):
    for r in worlds[4]:
        assert r["collectives"][form] == want


# ------------------------------------------------------------ the trainer


def _same(a, b):
    (pa, ha, sa), (pb, hb, sb) = a[:3], b[:3]
    return (ha == hb and torch.equal(sa.params, sb.params)
            and all(torch.equal(pa[k], pb[k]) for k in pa)
            and all(torch.equal(sa.opt_state[k], sb.opt_state[k]) for k in sa.opt_state
                    if sa.opt_state[k] is not None))


@pytest.mark.parametrize("case", TRAIN_CASES, ids=[case_id(c) for c in TRAIN_CASES])
def test_one_process_swept_sharded_is_bitwise_tree(tree_sweeps, case):
    impl, repr_, axes = case
    t = trainer("sharded", impl, repr_)
    out = sweep(t, grid(axes))
    assert t.mesh.group is None and t._sweep_plans[G].mesh.shape == {"grid": 1, "node": 1}
    assert _same(out, tree_sweeps[case_id(case)])


def _close(pop, hist, ref_pop, ref_hist):
    diff = sum(float(torch.sum((pop[k] - ref_pop[k]) ** 2)) for k in ref_pop)
    assert diff ** 0.5 < POP_L2
    assert [sorted(h) for h in hist] == [sorted(h) for h in ref_hist]
    for a, b in zip(hist, ref_hist):
        for k in b:
            assert abs(a[k] - b[k]) < LOSS_TOL, (k, a, b)


LAYOUT_CASES = [(w, layout, case) for w, layouts in LAYOUTS.items() for layout in layouts
                for case in TRAIN_CASES]


@pytest.mark.parametrize("world,layout,case", LAYOUT_CASES,
                         ids=[f"W{w}-{l[0]}x{l[1]}-{case_id(c)}" for w, l, c in LAYOUT_CASES])
def test_swept_sharded_matches_serial_sharded_and_tree(worlds, tree_sweeps, world, layout, case):
    results = worlds[world]
    key = (layout, case_id(case))
    pops, hists, _, gossip = results[0]["train"][key]
    for r in results[1:]:   # every rank returns the same grid
        assert r["train"][key][1] == hists
        assert all(torch.equal(r["train"][key][0][k], pops[k]) for k in pops)
    # one gossip collective a round on the node subgroup for the whole
    # block (psum is a dense schedule; the sparse tables ride allgather)
    want = {"all_gather_into_tensor": ROUNDS}
    if case[:2] == ("psum", "dense"):
        want = {"reduce_scatter_tensor": ROUNDS}
    if case[2] is AXES:   # the Markov schedule gathers the staleness too
        want = {"all_gather_into_tensor": 2 * ROUNDS}
    assert gossip == want
    params = assemble(results, layout, lambda r: r["train"][key][2].params)
    # each scenario against its serial sharded run on the node subgroup: bitwise
    g = grid(case[2])
    for s in range(G):
        gi = s // (G // layout[0])
        ranks = results[gi * layout[1]:(gi + 1) * layout[1]]
        pop, hist, _ = ranks[0]["serial"][(layout, case_id(case), s)]
        assert hists[s] == hist, s
        assert all(torch.equal(pops[k][s], pop[k]) for k in pop)
        rows = torch.cat([r["serial"][(layout, case_id(case), s)][2].params for r in ranks])
        assert torch.equal(params[s], rows)
    tpop, thist, tstate = tree_sweeps[case_id(case)]
    if layout[1] == 1:    # node width 1: the tree sweep's ops on the same operands
        assert hists == thist and torch.equal(params, tstate.params)
        for name in ("m", "v", "step"):
            opt = assemble(results, layout, lambda r: r["train"][key][2].opt_state[name])
            assert torch.equal(opt, tstate.opt_state[name])
    else:
        np.testing.assert_allclose(params.numpy(), tstate.params.numpy(), rtol=RTOL, atol=ATOL)
    for s in range(g.size):
        _close({k: v[s] for k, v in pops.items()}, hists[s],
               {k: v[s] for k, v in tpop.items()}, thist[s])


@pytest.mark.parametrize("world,layout", [(w, l) for w, ls in LAYOUTS.items() for l in ls])
@pytest.mark.parametrize("repr_,dp", [("dense", {}), ("sparse", DP)])
def test_masked_swept_sharded_is_bitwise_allgather(worlds, world, layout, repr_, dp):
    for r in worlds[world]:
        masked = r["train"][(layout, case_id(("masked", repr_, dp)))]
        plain = r["train"][(layout, case_id(("allgather", repr_, dp)))]
        assert masked[1] == plain[1] and torch.equal(masked[2].params, plain[2].params)


def test_two_by_two_matches_jax_tree_sweep(worlds, jax_run):
    (jpops, jhists, jstates), _, _ = jax_run
    results = worlds[4]
    pops, hists, _ = results[0]["jax"]
    for r in results[1:]:
        assert r["jax"][1] == hists
    params = assemble(results, (2, 2), lambda r: r["jax"][2].params).numpy()
    want = np.concatenate([np.asarray(jstates.params[k]).reshape(G, N, -1)
                           for k in sorted(jstates.params)], axis=-1)
    np.testing.assert_allclose(params, want, rtol=0, atol=1e-5)
    for s in range(G):
        assert [sorted(h) for h in hists[s]] == [sorted(h) for h in jhists[s]]
        for a, b in zip(hists[s], jhists[s]):
            for k in b:
                assert abs(a[k] - b[k]) <= 2e-6, (s, k, a, b)
        for k in pops:
            np.testing.assert_allclose(pops[k][s].numpy(), np.asarray(jpops[k])[s], rtol=0,
                                       atol=1e-5)
    staleness = assemble(results, (2, 2), lambda r: r["jax"][2].staleness)
    np.testing.assert_array_equal(staleness.numpy(), np.asarray(jstates.staleness))


def test_tree_sweep_over_ranks_and_foreign_meshes_are_refused():
    t = trainer("sharded", "allgather", "dense", mesh=make_sweep_mesh(G, N))
    with pytest.raises(ValueError, match="federation mesh"):
        t.train(torch.Generator().manual_seed(0), *fed()[:3], batch_size=BATCH, rounds=1)
    from repro_torch.launch.mesh import make_federation_mesh

    fmesh = trainer("sharded", "allgather", "dense", mesh=make_federation_mesh(N))
    with pytest.raises(ValueError, match=r"2-D \('grid', 'node'\) mesh"):
        sweep(fmesh, grid())
    kernel = trainer("kernel", "allgather", "dense")
    with pytest.raises(NotImplementedError, match="kernel"):
        sweep(kernel, grid())


# ------------------------------------------------------------ the CLI


@pytest.fixture(scope="module")
def cli_tree(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli_tree")
    with contextlib.redirect_stdout(io.StringIO()):
        return train_cli.run(CLI_BASE + ["--out", str(out)])


def test_one_process_cli_sweep_is_bitwise_tree(cli_tree, tmp_path, capsys):
    run = train_cli.run(CLI_BASE + ["--mixer", "sharded", "--num-processes", "1",
                                    "--gossip-impl", "auto", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "sweep mesh: {'grid': 1, 'node': 1} over 1 ranks" in out
    assert "gossip-impl auto -> allgather" in out and "gossip-repr auto -> dense" in out
    assert run.history == cli_tree.history and run.summary == cli_tree.summary
    assert all(torch.equal(run.population[k], cli_tree.population[k]) for k in run.population)


def test_two_process_cli_sweep_matches_the_tree_sweep(worlds, cli_tree):
    (h0, p0, c0, shape0, files0, out0), (h1, p1, c1, shape1, files1, out1) = (
        r["cli"] for r in worlds[2])
    # G=4 at OhioT1DM's N=12 over W=2: the node axis wins the tie
    assert shape0 == shape1 == {"grid": 1, "node": 2}
    assert h0 == h1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    assert c0 is not None and files0 == [c0.name] and c1 is None and files1 == []
    assert "sweep summary ->" in out0 and "sweep summary ->" not in out1
    for s in range(4):
        _close({k: v[s] for k, v in p0.items()}, h0[s],
               {k: v[s] for k, v in cli_tree.population.items()}, cli_tree.history[s])


if __name__ == "__main__":
    worker(sys.argv[1:])
