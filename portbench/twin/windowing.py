"""Windowing + normalization (paper §4.1 / §4.4); the benchmark's frozen
copy of ``repro_torch.data.windowing``.

  * split each patient's series 60/20/20 by time (train/val/test),
  * z-score with the TRAIN-split mean/SD of the patient's dataset,
  * missing values (NaN) -> 0 AFTER normalization (paper: "all missing
    values are replaced with zero"),
  * sliding windows of length L=12 predicting the sample H=6 ahead;
    windows whose TARGET is missing are dropped (targets must be real),
    windows with missing history are kept (zeros), matching the paper's
    zero-imputation policy.
"""
from __future__ import annotations

import numpy as np


def split_by_time(series: np.ndarray, fracs=(0.6, 0.2, 0.2)) -> tuple[np.ndarray, ...]:
    n = len(series)
    a = int(n * fracs[0])
    b = int(n * (fracs[0] + fracs[1]))
    return series[:a], series[a:b], series[b:]


def zscore_stats(train_parts: list[np.ndarray]) -> tuple[float, float]:
    """Dataset-level mean/SD over all patients' train splits (NaN-aware)."""
    cat = np.concatenate(train_parts)
    mean = float(np.nanmean(cat))
    sd = float(np.nanstd(cat))
    return mean, max(sd, 1e-6)


def normalize(series: np.ndarray, mean: float, sd: float) -> np.ndarray:
    out = (series - mean) / sd
    return np.nan_to_num(out, nan=0.0)


def make_windows(
    norm_series: np.ndarray,
    raw_series: np.ndarray,
    history_len: int = 12,
    horizon: int = 6,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (X, y_norm, y_raw): X is (M, L), targets are (M,).

    ``raw_series`` (mg/dL, with NaNs) decides target validity and supplies
    raw-unit targets for the clinical metrics.
    """
    L, H = history_len, horizon
    n = len(norm_series)
    m = n - L - H + 1
    if m <= 0:
        z = np.zeros((0,), np.float32)
        return np.zeros((0, L), np.float32), z, z
    idx = np.arange(m)[:, None] + np.arange(L)[None, :]
    X = norm_series[idx]
    tgt_pos = np.arange(m) + L + H - 1
    y_norm = norm_series[tgt_pos]
    y_raw = raw_series[tgt_pos]
    valid = ~np.isnan(y_raw)
    return (
        X[valid].astype(np.float32),
        y_norm[valid].astype(np.float32),
        y_raw[valid].astype(np.float32),
    )
