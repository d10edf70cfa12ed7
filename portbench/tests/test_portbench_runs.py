"""Whole runs of the harness on the CPU at a tiny size, with the look
for a card skipped: the command refuses to run without a card; a cell,
its configuration, traffic and a metric added as new files run without
an edit to an existing one, and the run loads no JAX; the control and
every fault the training cells can have come out not correct."""
import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench_tiny import PB, ROOT, TINY, tiny_bench, write_json

from portbench import check, harness, spec

SEED = 3_141_592_653


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    monkeypatch.setattr(harness, "HOST_THREADS", 1)
    torch.set_num_threads(1)


def _run(cell, root, bench, trace=False):
    c = spec.load_cell(cell, root, bench)
    return harness.run(c, SEED, 0.0, trace, time.perf_counter(), "cpu")


def test_command_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(PB / "run.py"), "--workload", "fig5_sweep.replace-bg-h128",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "CUDA device" in proc.stderr


def test_new_cell_and_metric_are_new_files(tmp_path):
    """A throwaway cell (configuration, traffic, workload) and metric
    reader, added as files and entries of BENCHMARK.json, run through
    the command's own entry in a fresh process that loads no JAX."""
    root, bench = tiny_bench(tmp_path)
    (root / "metrics" / "rounds_seen.py").write_text(
        "def read(run):\n    return float(run.scenario_rounds)\n")
    spec_ = json.loads(bench.read_text())
    spec_["workloads"].append({"name": "throwaway.tiny", "config": "tiny",
                               "traffic": "tiny_sweep", "chips": 1, "why": "a test"})
    spec_["workloads"] = [w for w in spec_["workloads"] if w["name"] != "tiny_sweep"]
    spec_["end_to_end"].append({"name": "rounds_seen", "unit": "rounds", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["throwaway.tiny"]})
    write_json(bench, spec_)
    (root / "workloads" / "throwaway.tiny.json").write_text(
        (root / "workloads" / "tiny_sweep.json").read_text())
    code = ("import sys, time; t0 = time.perf_counter(); "
            f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]; "
            "from pathlib import Path; from portbench import harness; harness.HOST_THREADS = 1; "
            "sys.exit(harness.main(['--workload', 'throwaway.tiny', '--seed', '7', "
            "'--seconds', '0', '--trace', '0'], t0, device='cpu', "
            f"root=Path({str(root)!r}), bench=Path({str(bench)!r})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"scenario_rounds_per_s", "setup_s", "rounds_seen"}
    assert result["metrics"]["rounds_seen"]["value"] == result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert proc.stderr.strip().splitlines()[-len(check.NUMBERS):] == [
        line for line in proc.stderr.strip().splitlines() if line.startswith("check ")]


def test_imports_no_jax_and_the_reference_none_of_the_program():
    banned = {"jax", "jaxlib", "flax", "repro"}
    plain = {"reference.py", "generator.py", "check.py", "costs.py", "devtrace.py"}
    for path in PB.rglob("*.py"):
        tops = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops.add(node.module.split(".")[0])
        assert not tops & (banned | {"benchmarks"}), path
        if path.name in plain:
            assert "repro_torch" not in tops, path


def _faulty(monkeypatch, fault):
    from repro_torch.core import gluadfl

    if fault == "state_unchanged":
        def step(self, premix, mixed, opt_state, data, batch_idx, shift=None):
            return premix, opt_state, torch.zeros(premix.shape[0], device=premix.device)
        monkeypatch.setattr(gluadfl.GluADFL, "_local_step", step)
    elif fault == "half_batch":
        plain = gluadfl.mse_value_and_grad

        def half(model, layout, params, bx, by):
            k = bx.shape[1] // 2
            return plain(model, layout, params, bx[:, :k], by[:, :k])
        monkeypatch.setattr(gluadfl, "mse_value_and_grad", half)
    elif fault == "answer_altered":
        plain_rmse = gluadfl.GluADFL.sweep_val_rmse
        monkeypatch.setattr(gluadfl.GluADFL, "sweep_val_rmse",
                            lambda self, *a: plain_rmse(self, *a) * (1 + 1e-3))


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "half_batch", "answer_altered"])
def test_faults_come_out_not_correct(tmp_path, monkeypatch, fault):
    """The tiny sweep run whole with the timed path broken underneath,
    held to the Fig-5 cell's limits: sound, it is correct; with each
    fault the training cells can have, it is not (the exchange between
    chips cannot fail on one chip)."""
    _faulty(monkeypatch, fault)
    root, bench = tiny_bench(tmp_path)
    result, lines = _run("tiny_sweep", root, bench)
    assert result["correct"] is (fault == "none"), lines


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_comes_out_not_correct(tmp_path, cell):
    """The reference in TF32, in the program's place, fails the real
    cell's limits."""
    root, bench = tiny_bench(tmp_path)
    c = spec.load_cell(cell, root, bench)
    data, drv, grid = harness.start(c, "cpu", [])
    ref = harness.reference_readings(c, data, grid, SEED, "cpu")
    control = harness.reference_readings(c, data, grid, SEED, "cpu", precision="tf32")
    ok, lines = check.judge(check.gaps(control, ref), c.workload["limits"])
    assert not ok, lines


def test_traced_run_on_the_cpu(tmp_path):
    """The traced path end to end: with no device in the trace, the
    device's metrics are left out rather than read as 0."""
    root, bench = tiny_bench(tmp_path)
    result, _ = _run("tiny_train", root, bench, trace=True)
    assert result["correct"] is True and result["metrics"] == {}
    assert "busy_s" not in result["device"] and "breakdown" not in result
