"""Federated data pipeline: the benchmark's frozen copy of
``repro_torch.data.pipeline`` (its loader alone).

Loads a dataset's synthetic twins, splits/normalizes/windows them, and
packs each patient's windows into fixed-size padded arrays so the whole
federation can be stacked into (N, M, L) tensors and sharded/vmapped.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from portbench.twin.synth import generate_dataset
from portbench.twin.windowing import make_windows, normalize, split_by_time, zscore_stats


@dataclass
class PatientData:
    """Windowed data for one patient (one federated node)."""

    train_x: np.ndarray  # (Mtr, L)
    train_y: np.ndarray  # (Mtr,)
    val_x: np.ndarray
    val_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    test_y_raw: np.ndarray  # mg/dL targets for clinical metrics
    mean: float
    sd: float


@dataclass
class FederatedData:
    """Whole-federation stacked arrays (node axis first, padded)."""

    name: str
    patients: list[PatientData]
    # stacked + padded for vmapped federated training:
    x: np.ndarray      # (N, M, L) float32
    y: np.ndarray      # (N, M)
    counts: np.ndarray  # (N,) true number of windows per node
    mean: float
    sd: float

    @property
    def num_nodes(self) -> int:
        return len(self.patients)


def load_federated_dataset(
    name: str,
    *,
    history_len: int = 12,
    horizon: int = 6,
    fast: bool = False,
    max_patients: int | None = None,
    seed: int = 0,
) -> FederatedData:
    raw = generate_dataset(name, fast=fast, max_patients=max_patients, seed=seed)
    splits = [split_by_time(s) for s in raw]
    mean, sd = zscore_stats([tr for tr, _, _ in splits])

    patients: list[PatientData] = []
    for tr, va, te in splits:
        ntr = normalize(tr, mean, sd)
        nva = normalize(va, mean, sd)
        nte = normalize(te, mean, sd)
        xtr, ytr, _ = make_windows(ntr, tr, history_len, horizon)
        xva, yva, _ = make_windows(nva, va, history_len, horizon)
        xte, yte, yte_raw = make_windows(nte, te, history_len, horizon)
        patients.append(
            PatientData(xtr, ytr, xva, yva, xte, yte, yte_raw, mean, sd)
        )

    # pad node window counts to the max so the federation stacks
    m = max(p.train_x.shape[0] for p in patients)
    L = history_len
    N = len(patients)
    x = np.zeros((N, m, L), np.float32)
    y = np.zeros((N, m), np.float32)
    counts = np.zeros((N,), np.int32)
    for i, p in enumerate(patients):
        k = p.train_x.shape[0]
        x[i, :k] = p.train_x
        y[i, :k] = p.train_y
        counts[i] = k
    return FederatedData(name, patients, x, y, counts, mean, sd)
