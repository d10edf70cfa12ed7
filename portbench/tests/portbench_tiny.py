"""Tiny cells for the benchmark's CPU tests: a copy of the benchmark's
files with a small configuration (8 patients of the 6-day twin, hidden
16) and two small traffic mixes, one a driver, held to the limits of the
real cells they stand for."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
for path in (ROOT, ROOT / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

# tiny cell -> (traffic it shrinks, real cell whose limits it is held to)
TINY = {"tiny_sweep": ("fig5_sweep", "fig5_sweep.replace-bg-h128"),
        "tiny_train": ("train_sparse", "train_sparse.replace-bg-h512")}


def write_json(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def tiny_bench(tmp: Path) -> tuple[Path, Path]:
    """A benchmark folder under ``tmp`` with the tiny cells added, and its
    ``BENCHMARK.json``."""
    root = tmp / "portbench"
    for sub in ("configs", "traffic", "workloads", "drivers", "metrics"):
        shutil.copytree(PB / sub, root / sub)
    cfg = json.loads((PB / "configs" / "gluadfl-lstm128-replace-bg.json").read_text())
    cfg.update(name="tiny", model={**cfg["model"], "hidden": 16},
               federation={"num_nodes": 8, "comm_batch": 1, "cluster_size": 4},
               dataset={"name": "replace-bg", "fast": True, "max_patients": 8, "horizon": 6})
    write_json(root / "configs" / "tiny.json", cfg)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, (traffic, real) in TINY.items():
        mix = json.loads((PB / "traffic" / f"{traffic}.json").read_text())
        mix.update(batch_size=8, chunk=4, trace_chunks=1,
                   eval={"every": 2, "set": "launcher", "units": "normalised"})
        if "topologies" in mix:
            mix.update(inactive_ratios=[0.5])
        write_json(root / "traffic" / f"{name}.json", mix)
        shutil.copy(PB / "workloads" / f"{real}.json", root / "workloads" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": "tiny", "traffic": name, "chips": 1,
                                   "why": "a CPU test"})
    write_json(tmp / "BENCHMARK.json", bench)
    return root, tmp / "BENCHMARK.json"
