"""The port's examples (``repro_torch.examples``) and paper driver
(``repro_torch.paper.run``) on the CPU.

  * each example's ``main(["--device", "cpu", ...])`` runs and prints
    only finite metrics: ``quickstart`` and ``serve_arch`` at the JAX
    scripts' sizes, ``cross_patient`` with ``--rounds 4`` of 300 and the
    ablation with 8 of its 80 rounds (the chip check runs all four at
    full size); torch runs on one thread here, as its small ops slow
    down many times over when the suite's workers share the cores;
  * ``topology_async_ablation``'s spectral gaps for ring and cluster
    equal ``repro.core.spectral_gap`` of the JAX package's mixing
    matrices (bitwise: the same float32 matrix, the same numpy
    eigenvalues);
  * the driver prints the CSV lines of ``benchmarks/run.py:main`` less
    ``bench_kernels`` and ``summarize_roofline`` (one line names both as
    not ported, with no number), and hands every experiment the scale,
    datasets and ratios JAX's driver hands it, with ``--quick``,
    ``--full`` and neither (the experiments themselves are held against
    JAX in ``tests/test_torch_paper.py`` and
    ``tests/test_torch_figures.py``).
"""
import dataclasses
import math
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import mixing_matrix as jax_mixing_matrix
from repro.core import round_adjacency as jax_round_adjacency
from repro.core import spectral_gap as jax_spectral_gap
from repro_torch.examples import cross_patient, quickstart, serve_arch, topology_async_ablation
from repro_torch.paper import run as driver

ROOT = Path(__file__).resolve().parents[1]
NUMBER = re.compile(r"(?<![\w.])[-+]?(?:\d+\.?\d*(?:e[-+]?\d+)?|nan|inf)(?![\w.])", re.I)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numbers(text: str) -> list[float]:
    return [float(v) for v in NUMBER.findall(text)]


def _assert_finite_output(text: str, at_least: int):
    values = _numbers(text)
    assert len(values) >= at_least, text
    assert all(math.isfinite(v) for v in values), text


def test_quickstart_runs_and_prints_finite_metrics(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "over 100 rounds" in out and "UNSEEN patient metrics:" in out
    metrics = out.split("UNSEEN patient metrics:")[1]
    assert all(k in metrics for k in ("rmse", "mard", "mae", "grmse", "time_lag"))
    _assert_finite_output(out, 10)


def test_cross_patient_runs_and_prints_finite_metrics(capsys):
    assert cross_patient.main(["--device", "cpu", "--rounds", "4"]) == 0
    out = capsys.readouterr().out
    for name in ("[gluadfl ]", "[fedavg  ]", "[mixed   ]", "[patient0]"):
        assert name in out
    _assert_finite_output(out, 8)


def test_topology_ablation_runs_and_its_gaps_are_jax_s(capsys, monkeypatch):
    gaps = []
    port_gap = topology_async_ablation.spectral_gap
    monkeypatch.setattr(topology_async_ablation, "spectral_gap",
                        lambda mix: gaps.append(port_gap(mix)) or gaps[-1])
    monkeypatch.setattr(topology_async_ablation, "ROUNDS", 8)
    assert topology_async_ablation.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.count("val RMSE") == 9 and "spectral gaps" in out
    _assert_finite_output(out, 12)
    n = 12  # the OhioT1DM twin's patients
    ones = jnp.ones((n,))
    for topo, got in zip(("ring", "cluster"), gaps):
        adj = jax_round_adjacency(topo, n, jax.random.PRNGKey(0), 7)
        assert got == jax_spectral_gap(jax_mixing_matrix(adj, ones, 7)), topo
    assert gaps[0] < gaps[1] and all(0.0 < g <= 1.0 for g in gaps)


def test_serve_arch_decodes_a_reduced_arch(capsys):
    assert serve_arch.main(["--device", "cpu", "--tokens", "4"]) == 0
    out = capsys.readouterr().out
    assert "arch=yi-6b" in out and "decoded 4 tokens" in out
    assert "yi-6b" in serve_arch.__doc__ and "mamba2" not in serve_arch.__doc__


# -------------------------------------------------------------- driver

EXPERIMENTS = ("table2_generalization", "table3_supervised", "table4_baselines",
               "fig3_personalization", "fig4_topology", "fig5_async")


def _stub_experiments(monkeypatch, package: str, calls: list):
    """Each experiment's ``run`` records its scale and arguments."""
    import importlib

    for name in EXPERIMENTS:
        mod = importlib.import_module(f"{package}.{name}")

        def run(scale, name=name, **kw):
            fields = {k: v for k, v in dataclasses.asdict(scale).items() if k != "device"}
            calls.append((name, fields, kw))
            return {"mean_unseen_minus_seen_rmse": 0.0}

        monkeypatch.setattr(mod, "run", run)


def _csv_names(text: str) -> list[str]:
    lines = text.splitlines()
    start = lines.index("name,us_per_call,derived")
    return [ln.split(",")[0] for ln in lines[start + 1:] if "," in ln]


@pytest.mark.parametrize("mode", [[], ["--quick"], ["--full"]], ids=["default", "quick", "full"])
def test_driver_runs_the_experiments_as_jax_s(mode, monkeypatch, capsys):
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.run as jrun

    jcalls, calls = [], []
    _stub_experiments(monkeypatch, "benchmarks", jcalls)
    _stub_experiments(monkeypatch, "repro_torch.paper", calls)
    for mod in (jrun, driver):
        monkeypatch.setattr(mod, "bench_fl_round", lambda *a: [])
    monkeypatch.setattr(jrun, "bench_kernels", lambda: ["kernel.stub,1,x"])
    monkeypatch.setattr(jrun, "summarize_roofline", lambda: ["roofline.stub,1,x"])
    monkeypatch.setattr(sys, "argv", ["run", *mode])
    jrun.main()
    jout = capsys.readouterr().out
    out_results = driver.drive([*mode, "--device", "cpu"])
    out = capsys.readouterr().out
    assert calls == jcalls and len(calls) == 6
    assert sorted(out_results) == ["fig3", "fig4", "fig5", "table2", "table3", "table4"]
    assert _csv_names(out) == [n for n in _csv_names(jout) if n not in ("kernel.stub",
                                                                           "roofline.stub")]
    not_ported = [ln for ln in out.splitlines() if "not ported" in ln]
    assert not_ported == [driver.NOT_PORTED]
    assert "bench_kernels" in not_ported[0] and "summarize_roofline" in not_ported[0]
    assert not _numbers(not_ported[0].split(":", 1)[1])


def test_driver_round_bench_lines_are_jax_s(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import benchmarks.run as jrun

    lines, jlines = driver.bench_fl_round("cpu", reps=2), jrun.bench_fl_round()
    assert [ln.split(",")[0] for ln in lines] == [ln.split(",")[0] for ln in jlines]
    assert [ln.split(",")[2] for ln in lines] == [ln.split(",")[2] for ln in jlines]
    assert all(float(ln.split(",")[1]) > 0 for ln in lines)
