"""The readings the limits of ``correct`` are set from, for one cell at
its own size (``PERF.md`` gives them beside each limit).  Not run by the
benchmark's runs.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...,12 \\
        --controls 101,102,103 [--out calibrate.jsonl]

One process sets the cell up once, then writes one JSON line a reading:

  * ``program``: the program's first rounds against the reference, on
    each of ``--seeds`` (the lower readings);
  * ``control``: the program with TF32 on, its own lower-precision path
    (the configurations state fp32 with TF32 off), against the reference;
    ``control_ref_tf32``: the reference with TF32-rounded matmuls in the
    program's place; on each of ``--controls``;
  * ``fault_half_batch``: the reference training on half of each batch
    in the program's place, on each of ``--controls``.
A state left unchanged reads 1 on ``grad_gap`` and ``change_gap`` by
their measure and needs no run.
"""
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench import check, harness, spec  # noqa: E402


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    dev = "cuda"
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else sys.stdout
    harness.configure(cell)
    lines: list = []
    data, drv, grid = harness.start(cell, dev, lines)
    half = cell.traffic["batch_size"] // 2

    def emit(kind, seed, numbers, seconds):
        rec = {"cell": cell.name, "kind": kind, "seed": seed, "seconds": seconds, **numbers}
        print(json.dumps(rec), file=out, flush=True)

    def program(seed, tf32=False):
        harness.configure(cell, tf32)
        _, _, prog = harness.checked_rounds(cell, drv, data, grid, seed, dev)
        harness.configure(cell)
        return prog

    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        prog = program(seed)
        ref = harness.reference_readings(cell, data, grid, seed, dev)
        emit("program", seed, check.gaps(prog, ref), time.perf_counter() - t)
    for seed in [int(s) for s in args.controls.split(",")]:
        t = time.perf_counter()
        ref = harness.reference_readings(cell, data, grid, seed, dev)
        emit("control", seed, check.gaps(program(seed, tf32=True), ref), time.perf_counter() - t)
        emit("control_ref_tf32", seed, check.gaps(
            harness.reference_readings(cell, data, grid, seed, dev, precision="tf32"), ref), 0.0)
        emit("fault_half_batch", seed, check.gaps(
            harness.reference_readings(cell, data, grid, seed, dev, keep_batch=half), ref), 0.0)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
