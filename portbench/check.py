"""The comparison that decides ``correct``: the program's readings after
its first rounds against the plain reference's, from the same inputs.

Five numbers, each held to its own limit (``limits`` of the cell's
workload file, set from the readings ``PERF.md`` gives):

  * ``loss_gap``: the worst round's and scenario's loss, relative;
  * ``grad_gap``: the worst leaf's norm of the first gradient as the
    optimizer got it, the gap between the two norms over the reference's
    norm of that leaf or of the scenario's median leaf, whichever is
    larger;
  * ``change_gap``: the same of each leaf's change over the rounds; a
    leaf whose reference gradient is under a thousandth of the median
    leaf's moves by round-off alone and is left out;
  * ``val_gap``: the worst population's val RMSE after the last round,
    relative;
  * ``pop_gap``: the worst population's distance from the reference's,
    relative to the reference's norm.
"""
from __future__ import annotations

import numpy as np

from portbench.reference import Readings

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "val_gap", "pop_gap")
QUIET_LEAF = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _norm_gap(prog: np.ndarray, ref: np.ndarray, keep: np.ndarray | None = None) -> float:
    """The worst leaf's |prog - ref| over max(ref, the scenario's median
    leaf), over (G, leaves) norms."""
    floor = np.median(ref, axis=1, keepdims=True)
    gap = np.abs(prog - ref) / np.maximum(np.maximum(ref, floor), 1e-30)
    if keep is not None:
        gap = np.where(keep, gap, 0.0)
    return float(gap.max())


def gaps(prog: Readings, ref: Readings) -> dict[str, float]:
    """The five numbers of ``prog`` against ``ref``."""
    loud = ref.grad >= QUIET_LEAF * np.median(ref.grad, axis=1, keepdims=True)
    pop_dist = np.linalg.norm(prog.pop.astype(np.float64) - ref.pop, axis=1)
    return {
        "loss_gap": float(np.max(np.abs(prog.loss - ref.loss) / np.abs(ref.loss))),
        "grad_gap": _norm_gap(prog.grad, ref.grad),
        "change_gap": _norm_gap(prog.change, ref.change, loud),
        "val_gap": float(np.max(np.abs(prog.val - ref.val) / ref.val)),
        "pop_gap": float(np.max(pop_dist / np.linalg.norm(ref.pop.astype(np.float64), axis=1))),
    }


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, list[str]]:
    """Whether every number is finite and within its limit, and one line
    a number: its name, value and limit."""
    lines, ok = [], True
    for name in NUMBERS:
        value, limit = numbers[name], limits[name]
        within = bool(np.isfinite(value)) and value <= limit
        ok = ok and within
        lines.append(f"check {name} {value!r} limit {limit!r} {'ok' if within else 'FAIL'}")
    return ok, lines
