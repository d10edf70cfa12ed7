"""One run of one cell of the port's benchmark.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up: the cell's files (``spec``), the card, the twin (``twin``; made
and cached by the first run in a checkout), the program's trainer
(``drivers/<driver>.py``), every row's initial params and the draw
stream from ``--seed`` (``generator``).  The first three rounds go through
the window's own call: one round, whose Adam state gives the first
gradient as the optimizer got it, then two with the eval after the
third; their readings are kept, and the same state goes on through one
warm-up chunk into the window.

Window: whole chunks of the engine (one ``train``/``train_sweep`` call
of ``chunk`` rounds each, one host sync a chunk) until ``--seconds``
have passed; the scenario-rounds over the seconds.  With ``--trace 1``
the window is ``trace_chunks`` chunks under ``torch.profiler`` instead,
and the run reports the per-layer metrics.

After the window the peak memory is read, the program's state is freed
and the plain reference (``reference``) follows the first three rounds
from the same inputs; ``check`` compares.  The last lines on standard
error are the compared numbers beside their limits, the last line on
standard output the result's JSON object.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import check, devtrace, generator, reference, spec, twin as twins
from portbench.reference import Readings, change_norms, flat_pops, leaf_norms

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}  # top-level module names
CHECKED_ROUNDS = 3
HOST_THREADS = 1  # the host only launches work; one thread keeps runs steady


@dataclass
class Run:
    """What the metric readers read: the set-up and window on the host
    clock, the peak memory, the traced window's profile and the work the
    traced rounds required."""

    cell: spec.Cell
    nodes: int
    setup_s: float
    window_s: float
    scenario_rounds: int
    peak_bytes: int | None
    trace: devtrace.Trace | None = None
    traced_rounds: int = 0
    traced_evals: int = 0
    active_rows: list = field(default_factory=list)  # a list of G a traced round
    eval_launches: list = field(default_factory=list)  # (G, R, L, I, H) of an eval round


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def main(argv, t0: float, *, device: str = "cuda", root: Path = spec.HERE,
         bench: Path | None = None) -> int:
    """The command: one run, its result on the last line of stdout.
    ``device="cpu"``, a ``root`` and a ``bench`` are for the CPU tests,
    which skip the look for a card."""
    args = parse(argv)
    cell = spec.load_cell(args.workload, root, bench)
    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (the system under test: fail here without it)

    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), t0, device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def configure(cell: spec.Cell, tf32: bool | None = None) -> None:
    """Few host threads, and TF32 as the configuration states (or as
    ``tf32`` says: the control's program path)."""
    import torch

    torch.set_num_threads(HOST_THREADS)
    on = bool(cell.config["tf32"]) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def start(cell: spec.Cell, device: str, lines: list):
    """The twin (made on a checkout's first run), the driver with the
    program's trainer, and the traffic's scenarios."""
    data, made_s = twins.load({**cell.config["dataset"],
                               "history_len": cell.config["model"]["history_len"]},
                              cell.root / "cache")
    if made_s is not None:
        lines.append(f"twin {cell.config['dataset']['name']} generated in {made_s!r} s")
    if device == "cuda":
        data.x, data.y = pinned(data.x), pinned(data.y)
    return data, cell.driver().Driver(cell, data, device), generator.scenarios(cell.traffic)


def pinned(a: np.ndarray) -> np.ndarray:
    """``a`` in page-locked host memory.  The engine uploads its host
    arrays at every call, and the window calls it once a chunk: from
    page-locked memory that upload is one DMA copy, not a staged copy
    whose speed moves with the host from one process to the next."""
    import torch

    t = torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype, pin_memory=True)
    out = t.numpy()  # keeps ``t`` alive
    out[...] = a
    return out


def draws_of(cell: spec.Cell, data, grid, seed: int, device: str) -> generator.Draws:
    return generator.Draws(seed, data.counts, grid, cell.traffic["local_steps"],
                           cell.traffic["batch_size"], device)


def checked_rounds(cell: spec.Cell, drv, data, grid, seed: int, device: str):
    """A fresh state from ``seed`` through the first rounds, by the
    window's own call and feed: one round, whose Adam state gives the
    first gradient as the optimizer got it, then the rest with the eval
    after the last.  Returns the state, the draw stream (to go on with)
    and the program's readings."""
    model, b1 = cell.config["model"], cell.traffic["optimizer"]["b1"]
    rows = drv.g * drv.n
    draws = draws_of(cell, data, grid, seed, device)
    state = drv.start(generator.init_leaves(model, rows, seed, device))
    state, loss1, _, _ = drv.call(state, draws, 1, 0)
    views = drv.trainer.layout.views
    grad = leaf_norms(views(drv.flat(state.opt_state["m"]) / (1 - b1)), drv.g)
    state, rest, evals, pops = drv.call(state, draws, CHECKED_ROUNDS - 1, CHECKED_ROUNDS - 1)
    change = change_norms(views(drv.flat(state.params)),
                          generator.init_leaves(model, rows, seed, device), drv.g)
    return state, draws, Readings(loss=np.concatenate([loss1, rest], axis=1), grad=grad,
                                  change=change, val=evals[max(evals)], pop=flat_pops(pops))


def reference_readings(cell: spec.Cell, data, grid, seed: int, device: str,
                       **kw) -> Readings:
    """The plain reference through the first rounds from the same
    inputs; ``kw`` as ``reference.follow`` takes them (the control's
    precision, the half-batch fault)."""
    rows = len(grid) * data.num_nodes
    return reference.follow(reference_setup(cell, data, grid, device),
                            generator.init_leaves(cell.config["model"], rows, seed, device),
                            draws_of(cell, data, grid, seed, device), CHECKED_ROUNDS, **kw)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, t0: float, device: str):
    import torch

    configure(cell)
    lines = []
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", time.perf_counter() - t0)]  # set-up's steps, for PERF.md
    data, drv, grid = start(cell, device, lines)
    marks.append(("twin and trainer", time.perf_counter() - t0))
    state, draws, prog = checked_rounds(cell, drv, data, grid, seed, device)
    marks.append(("checked rounds", time.perf_counter() - t0))
    chunk, every = cell.traffic["chunk"], cell.traffic["eval"]["every"]
    state, _, _, _ = drv.call(state, draws, chunk, every)  # warm-up
    _sync(device)
    setup_s = time.perf_counter() - t0
    marks.append(("warm-up chunk", setup_s))
    lines.append("setup_s " + ", ".join(f"{name} at {s!r}" for name, s in marks))

    done, losses, prof = 0, [], None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        draws.record = True
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(devtrace.WINDOW):
                w0 = time.perf_counter()
                for _ in range(cell.traffic["trace_chunks"]):
                    state, loss, _, _ = drv.call(state, draws, chunk, every)
                    losses.append(loss)
                    done += chunk
                _sync(device)
                window_s = time.perf_counter() - w0
    else:
        w0 = time.perf_counter()
        ends = []
        while True:
            state, loss, _, _ = drv.call(state, draws, chunk, every)
            losses.append(loss)
            done += chunk
            ends.append(time.perf_counter() - w0)
            if ends[-1] >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - w0
        lines.append(f"chunk_s {[b - a for a, b in zip([0.0] + ends, ends)]!r}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else None
    info = Run(cell, drv.n, setup_s, window_s, done * drv.g, peak,
               eval_launches=drv.eval_launches)
    if prof is not None:
        info.trace = devtrace.read(prof)
        info.traced_rounds, info.traced_evals = done, done // chunk * (chunk // every)
        info.active_rows = draws.active_rows()
        lines.append(f"span_ms_per_round {({k: v / done for k, v in info.trace.span_ms.items()})!r}")
    window_losses = np.concatenate(losses, axis=1)
    del state, drv, draws, prof
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    ref = reference_readings(cell, data, grid, seed, device)
    numbers = check.gaps(prog, ref)
    correct, check_lines = check.judge(numbers, cell.workload["limits"])
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(info)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": int(window_losses.size),
        "failed": int((~np.isfinite(window_losses)).sum()),
        "metrics": metrics,
        "device": device_info(device, cell.chips, info),
    }
    if info.trace is not None and info.trace.busy_s > 0:
        result["breakdown"] = info.trace.breakdown()
    result["checks"] = {k: {"value": numbers[k], "limit": cell.workload["limits"][k]}
                        for k in check.NUMBERS}
    return result, lines + check_lines


def device_info(device: str, chips: int, info: Run) -> dict:
    """The result's ``device``; a traced run's busy and window seconds."""
    import torch

    out = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": chips, "memory_peak_bytes": info.peak_bytes or 0}
    if info.trace is not None and info.trace.busy_s > 0:
        out["busy_s"], out["window_s"] = info.trace.busy_s, info.window_s
    return out


def reference_setup(cell: spec.Cell, data, grid, device) -> reference.Setup:
    """The reference's inputs: the sizes and rules from the cell's files,
    the twin's arrays moved to the device anew."""
    import torch

    fed, tr = cell.config["federation"], cell.traffic
    opt = tr["optimizer"]
    vx, vy = data.val_set(tr["eval"]["set"])

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32)).to(device)
    return reference.Setup(
        comm_batch=fed["comm_batch"], cluster_size=fed["cluster_size"], grid=grid,
        local_steps=tr["local_steps"], lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
        eps=opt["eps"], x=dev(data.x), y=dev(data.y), val_x=dev(vx), val_y=dev(vy),
        units_scale=data.sd if tr["eval"]["units"] == "mgdl" else 1.0)
