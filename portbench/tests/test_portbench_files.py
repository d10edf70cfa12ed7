"""The benchmark's files: BENCHMARK.json's shape and limits, and every
configuration, traffic mix, workload, driver and metric reader found by
its name."""
import json
import re

import pytest

from portbench_tiny import PB, ROOT

from portbench import check, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ONE_LINE = re.compile(r"[^\t\n\r]{1,200}")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"] and BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for entry in BENCH[group]:
            allowed = want | ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            assert want <= set(entry) <= allowed, entry
            assert spec.valid_name(entry["name"]), entry["name"]
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert ONE_LINE.fullmatch(entry[key]), entry[key]


def test_names_units_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.valid_unit(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert set(m.get("workloads", cells)) <= cells, m
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace"), m
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock"), m
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%", m
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and spec.valid_name(w["traffic"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(cells) // 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"] == f"portbench/configs/{c['name']}.json", c
        assert all(spec.valid_name(k) for k in c["reduced"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == [w for w in BENCH["workloads"] if w["name"] == cell][0]["config"]
    assert set(c.workload["limits"]) == set(check.NUMBERS)
    assert all(0 < v < 1 for v in c.workload["limits"].values())
    assert hasattr(c.driver(), "Driver")
    for m in c.end_to_end + c.per_layer:
        assert callable(c.reader(m["name"]))
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    assert c.per_layer


def test_every_file_is_named_by_the_benchmark():
    """No orphan: each data file and reader under the benchmark is some
    entry's (or a driver a traffic mix names)."""
    names = {"configs": {c["name"] for c in BENCH["configs"]},
             "traffic": {w["traffic"] for w in BENCH["workloads"]},
             "workloads": {w["name"] for w in BENCH["workloads"]},
             "metrics": {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}}
    for sub, want in names.items():
        have = {p.name.rsplit(".", 1)[0] for p in (PB / sub).iterdir() if p.suffix in (".json", ".py")}
        assert have == want, (sub, have ^ want)
    drivers = {json.loads((PB / "traffic" / f"{t}.json").read_text())["driver"]
               for t in names["traffic"]}
    assert {p.stem for p in (PB / "drivers").glob("*.py")} == drivers
