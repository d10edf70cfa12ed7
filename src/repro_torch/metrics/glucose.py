"""Clinical BGLP metrics (paper §4.3), in mg/dL unless noted: a numpy
copy of ``repro.metrics.glucose``, held bitwise against it.

RMSE, MARD(%), MAE, glucose-specific RMSE (gRMSE, Del Favero et al. 2012
penalty), and time lag via cross-correlation (Cohen 1995).
"""
from __future__ import annotations

import numpy as np


def rmse(y: np.ndarray, yhat: np.ndarray) -> float:
    return float(np.sqrt(np.mean(np.square(y - yhat))))


def mard(y: np.ndarray, yhat: np.ndarray) -> float:
    y_safe = np.maximum(np.abs(y), 1e-6)
    return float(np.mean(np.abs(y - yhat) / y_safe) * 100.0)


def mae(y: np.ndarray, yhat: np.ndarray) -> float:
    return float(np.mean(np.abs(y - yhat)))


def _grmse_penalty(y: np.ndarray, yhat: np.ndarray) -> np.ndarray:
    """Del Favero-style clinically asymmetric penalty P(y, yhat) >= 1.

    Penalizes overestimation in hypoglycemia (y < 70) and underestimation
    in hyperglycemia (y > 180).  Smooth sigmoid ramp, max penalty x2.5.
    """
    over = yhat > y
    under = ~over
    hypo = 1.0 / (1.0 + np.exp((y - 70.0) / 5.0))   # ~1 deep in hypo
    hyper = 1.0 / (1.0 + np.exp((180.0 - y) / 10.0))  # ~1 deep in hyper
    pen = 1.0 + 1.5 * (hypo * over + hyper * under)
    return pen


def grmse(y: np.ndarray, yhat: np.ndarray) -> float:
    pen = _grmse_penalty(y, yhat)
    return float(np.sqrt(np.mean(pen * np.square(y - yhat))))


def time_lag_minutes(
    y: np.ndarray, yhat: np.ndarray, sample_minutes: float = 5.0, max_shift: int = 12
) -> float:
    """Temporal lag between prediction and truth via cross-correlation.

    Finds the shift k >= 0 maximizing corr(y[t-k], yhat[t]); the reported
    lag is k * sample_minutes.  Series must be time-ordered.
    """
    y = np.asarray(y, np.float64)
    yhat = np.asarray(yhat, np.float64)
    n = min(len(y), len(yhat))
    if n < max_shift + 2:
        return 0.0
    y, yhat = y[:n], yhat[:n]
    best_k, best_c = 0, -np.inf
    for k in range(max_shift + 1):
        a = y[: n - k]
        b = yhat[k:]
        sa, sb = a.std(), b.std()
        c = -np.inf if sa < 1e-9 or sb < 1e-9 else float(
            np.mean((a - a.mean()) * (b - b.mean())) / (sa * sb)
        )
        if c > best_c:
            best_c, best_k = c, k
    return best_k * sample_minutes


def all_metrics(y_raw: np.ndarray, yhat_raw: np.ndarray) -> dict[str, float]:
    return {
        "rmse": rmse(y_raw, yhat_raw),
        "mard": mard(y_raw, yhat_raw),
        "mae": mae(y_raw, yhat_raw),
        "grmse": grmse(y_raw, yhat_raw),
        "time_lag": time_lag_minutes(y_raw, yhat_raw),
    }
