"""Finding a cell's files by name.

``BENCHMARK.json`` at the repository root lists the cells, the
configurations and the metrics; everything that belongs to one of them
is a file of its own under the benchmark's folder, found by its name:

  * ``configs/<configuration>.json``: the model and federation as run;
  * ``traffic/<traffic>.json``: the traffic mix, naming its driver;
  * ``drivers/<driver>.py``: how the window drives the program;
  * ``workloads/<cell>.json``: the cell's limits for ``correct``;
  * ``metrics/<metric>.py``: the reader of one metric, ``read(run)``.

So a later change adds a cell, a configuration, a driver or a metric as
new files (and entries in ``BENCHMARK.json``), and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


def valid_name(name: str) -> bool:
    return isinstance(name, str) and NAME.fullmatch(name) is not None


def valid_unit(unit: str) -> bool:
    return isinstance(unit, str) and UNIT.fullmatch(unit) is not None


def load_module(path: Path, label: str):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{label}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list[dict]    # the BENCHMARK.json entries this cell reports
    per_layer: list[dict]
    root: Path

    def reader(self, metric: str):
        """The ``read(run)`` of ``metrics/<metric>.py``."""
        return load_module(self.root / "metrics" / f"{metric}.py", f"metric_{metric}").read

    def driver(self):
        """The module of ``drivers/<driver>.py``."""
        kind = self.traffic["driver"]
        return load_module(self.root / "drivers" / f"{kind}.py", f"driver_{kind}")


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = HERE, bench: Path | None = None) -> Cell:
    """The cell ``name`` of ``bench`` (default: ``BENCHMARK.json`` beside
    ``root``) with its files under ``root``."""
    bench = _json(bench or root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[name]
    return Cell(
        name=name, chips=int(w["chips"]), config=_json(root / "configs" / f"{w['config']}.json"),
        traffic=_json(root / "traffic" / f"{w['traffic']}.json"),
        workload=_json(root / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
        root=root,
    )
