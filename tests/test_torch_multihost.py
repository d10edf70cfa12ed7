"""The port's multi-process bootstrap (``repro_torch.launch.multihost``)
and the training CLI's multi-process flags, on the CPU.

One spawn starts two ranks of this file's ``__main__`` worker (gloo,
``--device cpu``, a free localhost port, a timeout, the children
killed on the way out).  Each rank calls
``repro_torch.launch.train.run`` with ``--num-processes 2 --process-id r
--coordinator 127.0.0.1:<port>`` on the OhioT1DM fast twin (N=12, six
rows a rank), H=8, 3 rounds, an eval every 2, for the ``allgather``
(the default ``--mixer tree`` overridden to ``sharded``), ``psum`` and
sparse ``gather`` schedules, then the refusals: ``--engine loop``,
``--chunk 0``, a tree sweep, and ABC4D's N=25 over two ranks; and a
``--mixer sharded`` sweep, which runs.  The tests hold
each run against the one-process ``--mixer tree`` run: both ranks'
histories bitwise equal, rank 0's population within an L2 of 1e-4 and
its losses and val RMSE within 1e-4 (the JAX package's sharded-trainer
bounds), and only rank 0 writing the checkpoint.

In process: ``--mixer sharded --num-processes 1`` is bitwise the tree
mixer's run, and the bootstrap's one-process no-op, environment and
placement.
"""
from __future__ import annotations

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.distributed import addressable_node_rows
from repro_torch.launch import multihost
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import FederationMesh, make_federation_mesh
from test_torch_distributed import LOSS_TOL, POP_L2, rank_results, spawn_ranks, worker_args

BASE = ["--device", "cpu", "--fast-data", "--rounds", "3", "--hidden", "8", "--eval-every", "2"]
CLI_CASES = {"allgather": [], "psum": ["--gossip-impl", "psum"],
             "gather": ["--gossip-impl", "gather", "--gossip-repr", "sparse"]}
SHARDED_SWEEP = ["--sweep-ratios", "0,0.5", "--mixer", "sharded"]
REFUSALS = {"loop": ["--engine", "loop"], "chunk0": ["--chunk", "0"],
            "sweep": ["--sweep-ratios", "0,0.5"], "N25": ["--dataset", "abc4d"]}


def worker(argv) -> None:
    """One rank: every CLI case and refusal in one process group, then
    its results to ``out/rank<r>.pt``."""
    torch.set_num_threads(1)
    args = worker_args(argv)
    flags = ["--num-processes", str(args.world), "--process-id", str(args.rank),
             "--coordinator", f"127.0.0.1:{args.port}"]
    res = {"runs": {}, "refused": {}}
    for name, extra in CLI_CASES.items():
        out = args.out / f"rank{args.rank}" / name
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            run = train_cli.run(BASE + flags + extra + ["--out", str(out)])
        res["runs"][name] = (run.history, run.population, run.checkpoint, run.trainer.plan.backend,
                             sorted(p.name for p in out.glob("*")) if out.exists() else [],
                             printed.getvalue())
    out = args.out / f"rank{args.rank}" / "sweep"
    with contextlib.redirect_stdout(io.StringIO()):
        run = train_cli.run(BASE + flags + SHARDED_SWEEP + ["--out", str(out)])
    res["sweep"] = (run.history, run.checkpoint, run.trainer.mesh.shape)
    for name, extra in REFUSALS.items():
        try:
            train_cli.run(BASE + flags + extra + ["--out", str(args.out / "refused")])
        except (train_cli.Refused, ValueError) as e:
            res["refused"][name] = f"{type(e).__name__}: {e}"
    torch.save(res, args.out / f"rank{args.rank}.pt")
    multihost.barrier()
    multihost.shutdown()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("cli2")
    spawn_ranks(Path(__file__), 2, out)
    return rank_results(out, 2)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The one-process ``--mixer tree`` run of every CLI case."""
    out = tmp_path_factory.mktemp("cli1")
    with contextlib.redirect_stdout(io.StringIO()):
        return {name: train_cli.run(BASE + ["--mixer", "tree", "--out", str(out / name)]
                                    + (["--gossip-repr", "sparse"] if name == "gather" else []))
                for name in CLI_CASES}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_two_rank_cli_matches_the_one_process_tree_run(ranks, one_process, name):
    (h0, p0, c0, backend, files0, out0), (h1, p1, c1, _, files1, out1) = (
        r["runs"][name] for r in ranks)
    ref = one_process[name]
    assert backend == ("sharded_gather_tables" if name == "gather" else "sharded")
    assert h0 == h1 and all(torch.equal(p0[k], p1[k]) for k in p0)
    l2 = sum(float(torch.sum((p0[k] - ref.population[k]) ** 2)) for k in p0) ** 0.5
    assert l2 < POP_L2
    assert [sorted(h) for h in h0] == [sorted(h) for h in ref.history]
    for a, b in zip(h0, ref.history):
        for k in b:
            assert abs(a[k] - b[k]) < LOSS_TOL, (k, a, b)
    # rank 0 alone prints the report and writes the checkpoint
    assert c0 is not None and files0 == [c0.name] and c1 is None and files1 == []
    assert "checkpoint ->" in out0 and "checkpoint ->" not in out1
    assert "patient   0" in out0 and "patient   0" not in out1
    vec = np.load(c0)["vec"]
    np.testing.assert_allclose(vec, np.load(ref.checkpoint)["vec"], rtol=0, atol=POP_L2)
    note = "multihost: overriding --mixer tree -> sharded"
    assert all(note in out for out in (out0, out1))


@pytest.mark.parametrize("name,words", [("loop", ("scan engine",)), ("chunk0", ("scan engine",)),
                                        ("sweep", ("single-process",)),
                                        ("N25", ("ValueError", "N=25", "W=2"))])
def test_two_rank_cli_refusals(ranks, name, words):
    for r in ranks:
        assert all(w in r["refused"][name] for w in words), r["refused"][name]


def test_one_process_sharded_cli_is_bitwise_tree(tmp_path, capsys):
    """``--mixer sharded --gossip-impl gather --num-processes 1`` (no
    group: the one-process mesh) trains bitwise like ``--mixer tree``."""
    runs = {m: train_cli.run(BASE + ["--mixer", m, "--gossip-repr", "sparse", "--out",
                                     str(tmp_path / m)] + extra)
            for m, extra in (("tree", []),
                             ("sharded", ["--gossip-impl", "gather", "--num-processes", "1"]))}
    assert runs["sharded"].trainer.mesh.width == 1
    assert runs["sharded"].history == runs["tree"].history
    a, b = (np.load(runs[m].checkpoint)["vec"] for m in ("tree", "sharded"))
    assert a.tobytes() == b.tobytes()
    assert "multihost" not in capsys.readouterr().out


def test_a_sweep_over_two_processes_needs_the_sharded_mixer(ranks):
    """A tree sweep on ``--num-processes 2`` is refused (it batches
    scenarios on one process); ``--mixer sharded`` runs it on the sweep
    mesh, both ranks with every scenario's history, rank 0 alone writing
    the summary."""
    for r in ranks:
        assert "single-process" in r["refused"]["sweep"]
        assert "--mixer sharded" in r["refused"]["sweep"]
    (h0, c0, shape0), (h1, c1, shape1) = (r["sweep"] for r in ranks)
    assert shape0 == shape1 == {"grid": 1, "node": 2}
    assert len(h0) == 2 and h0 == h1 and all(len(h) == 3 for h in h0)
    assert c0 is not None and c0.name == "sweep_ohiot1dm_random.json" and c1 is None


def test_initialize_is_a_no_op_on_one_process(monkeypatch):
    for k in (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES, multihost.ENV_PROCESS_ID):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert multihost.initialize("127.0.0.1:1", 1, 0, device="cpu") is False
    monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "2")
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(device="cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.is_primary()
    multihost.barrier()
    multihost.shutdown()


def test_one_process_mesh_and_placement():
    mesh = make_federation_mesh(12, device="cpu")
    assert (mesh.group, mesh.width, mesh.rank, mesh.rows) == (None, 1, 0, slice(0, 12))
    x = np.arange(12 * 3 * 2, dtype=np.float32).reshape(12, 3, 2)
    y = np.arange(12 * 3, dtype=np.float32).reshape(12, 3)
    counts = np.arange(12)
    val = (x[0], y[0])
    second = FederationMesh(None, 2, 1, 12)
    px, py, pc, pval = multihost.place_federation(second, x, y, counts, val, device="cpu")
    np.testing.assert_array_equal(px.numpy(), x[6:])
    np.testing.assert_array_equal(py.numpy(), y[6:])
    np.testing.assert_array_equal(pc.numpy(), counts)
    assert pc.dtype == torch.int64 and np.array_equal(pval[0].numpy(), x[0])
    with pytest.raises(ValueError, match="owns no whole block"):
        multihost.place_federation(FederationMesh(None, 5, 0, 12), x, y, counts, device="cpu")
    assert addressable_node_rows(second, 12) == slice(6, 12)
    got = multihost.fetch_replicated({"a": torch.ones(2)})
    assert isinstance(got["a"], np.ndarray) and got["a"].tolist() == [1.0, 1.0]


if __name__ == "__main__":
    worker(sys.argv[1:])
