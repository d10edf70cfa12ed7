"""The benchmark's training data: a dataset's synthetic twin, made by the
frozen copy of the port's generator in this folder and kept on disk.

The first run in a checkout generates the twin (about half a minute of
numpy for REPLACE-BG at its full 251 days) and writes its arrays under
``portbench/cache/<dataset>-<key>/``, where the key is a hash of the
generator's sources and the dataset's parameters; later runs load them.
The directory is written under a temporary name and renamed, so a run
that is cut leaves no half-written cache.  The patients are the twin's
fixed data, as a public dataset's would be: ``--seed`` does not touch
them.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ARRAYS = ("x", "y", "counts", "val_x", "val_y", "val_counts")


@dataclass
class Twin:
    """A federation's padded training windows and its pooled val windows."""

    x: np.ndarray           # (N, M, L) float32, padded
    y: np.ndarray           # (N, M)
    counts: np.ndarray      # (N,) int32, true windows a patient
    val_x: np.ndarray       # (V, L) every patient's val windows, patient-major
    val_y: np.ndarray       # (V,)
    val_counts: np.ndarray  # (N,) val windows a patient
    mean: float             # the train splits' z-score mean, mg/dL
    sd: float

    @property
    def num_nodes(self) -> int:
        return int(self.x.shape[0])

    def val_set(self, which: str) -> tuple[np.ndarray, np.ndarray]:
        """``"launcher"``: the first ``2048 // N`` val windows of every
        patient, as ``repro_torch.launch.train.val_windows`` takes them
        (2,034 at N=226); ``"pooled"``: every val window."""
        if which == "pooled":
            return self.val_x, self.val_y
        if which != "launcher":
            raise ValueError(f"unknown eval set {which!r}")
        cap = max(1, 2048 // self.num_nodes)
        starts = np.concatenate([[0], np.cumsum(self.val_counts)[:-1]])
        rows = np.concatenate([s + np.arange(min(cap, c)) for s, c in zip(starts, self.val_counts)])
        return self.val_x[rows], self.val_y[rows]


def _key(params: dict) -> str:
    digest = hashlib.sha256(json.dumps(params, sort_keys=True).encode())
    for name in ("synth.py", "windowing.py", "pipeline.py", "__init__.py"):
        digest.update((HERE / name).read_bytes())
    return digest.hexdigest()[:16]


def generate(params: dict) -> Twin:
    """The twin of ``params`` (``name``, ``fast``, ``max_patients``,
    ``history_len``, ``horizon``) from the frozen generator."""
    from portbench.twin.pipeline import load_federated_dataset

    fed = load_federated_dataset(params["name"], history_len=params["history_len"],
                                 horizon=params["horizon"], fast=params["fast"],
                                 max_patients=params["max_patients"])
    return Twin(fed.x, fed.y, fed.counts,
                np.concatenate([p.val_x for p in fed.patients]),
                np.concatenate([p.val_y for p in fed.patients]),
                np.array([len(p.val_y) for p in fed.patients], np.int64), fed.mean, fed.sd)


def load(params: dict, cache: Path) -> tuple[Twin, float | None]:
    """The twin of ``params`` from ``cache``, generated and written there
    first if it is missing; also the seconds the generation took (None
    when it was loaded)."""
    where = cache / f"{params['name']}-{_key(params)}"
    if (where / "meta.json").exists():
        meta = json.loads((where / "meta.json").read_text())
        arrays = {k: np.load(where / f"{k}.npy") for k in ARRAYS}
        return Twin(**arrays, mean=meta["mean"], sd=meta["sd"]), None
    t0 = time.perf_counter()
    twin = generate(params)
    seconds = time.perf_counter() - t0
    tmp = cache / f".{where.name}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    for k in ARRAYS:
        np.save(tmp / f"{k}.npy", getattr(twin, k))
    (tmp / "meta.json").write_text(json.dumps({"mean": twin.mean, "sd": twin.sd, **params}))
    try:
        os.replace(tmp, where)
    except OSError:  # another run wrote it first
        shutil.rmtree(tmp, ignore_errors=True)
    return twin, seconds
