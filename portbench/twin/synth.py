"""Synthetic CGM generator — calibrated stand-ins for the four clinical
datasets (OhioT1DM, ABC4D, CTR3, REPLACE-BG).  The benchmark's frozen
copy of ``repro_torch.data.synth``, so that a change to the program's
generator cannot move the benchmark's inputs; the same seeds give
bitwise the same series (``tests/test_portbench_twin.py``).

The real datasets are access-controlled (see DESIGN.md §5).  The generator
reproduces the population statistics the paper reports in Table 1:

  dataset      N    days  records/patient  mean(SD) mg/dL   SD(SD) mg/dL
  ohiot1dm     12     54     ~13871         159.35(16.34)    58.11(6.15)
  abc4d        25    168     ~43259         156.66(24.24)    60.52(14.47)
  ctr3         30    163     ~43421         151.37(13.34)    55.29(8.24)
  replace-bg  226    251     ~66153         160.69(21.18)    60.33(11.65)

Mechanism per patient (5-minute sampling):
  * circadian baseline (24h + 12h sinusoids, patient-specific phase),
  * 3±1 meals/day -> glucose response bumps (gamma-like rise/decay),
  * insulin-like corrective decay pulling toward the patient's basal,
  * AR(1) sensor noise,
  * dataset-specific variability scale (ABC4D largest: pen therapy),
  * clipping to the CGM range [40, 400] mg/dL,
  * missing samples (sensor dropouts) as NaN with dataset-specific rate.

Everything is vectorized numpy (host-side data pipeline, as a real input
pipeline would be) and deterministic given (dataset, patient id, seed).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SAMPLES_PER_DAY = 288  # 5-minute CGM sampling


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_patients: int
    num_days: int
    mean_bg: float          # population mean of per-patient means
    mean_bg_sd: float       # SD across patients of per-patient means
    sd_bg: float            # population mean of per-patient SDs
    sd_bg_sd: float         # SD across patients of per-patient SDs
    missing_rate: float
    meal_irregularity: float  # ABC4D (pen) > pump datasets
    seed_base: int


DATASET_SPECS: dict[str, DatasetSpec] = {
    "ohiot1dm": DatasetSpec("ohiot1dm", 12, 54, 159.35, 16.34, 58.11, 6.15, 0.04, 0.6, 101),
    "abc4d": DatasetSpec("abc4d", 25, 168, 156.66, 24.24, 60.52, 14.47, 0.05, 1.0, 202),
    "ctr3": DatasetSpec("ctr3", 30, 163, 151.37, 13.34, 55.29, 8.24, 0.03, 0.5, 303),
    "replace-bg": DatasetSpec("replace-bg", 226, 251, 160.69, 21.18, 60.33, 11.65, 0.04, 0.7, 404),
}

# Smoke-scale day counts so tests don't generate 251-day series.
_FAST_DAYS = 6


def node_skew_offsets(num_nodes: int) -> np.ndarray:
    """Deterministic centered per-node offsets in ``[-1, 1]``, float32.

    The non-IID skew axis shifts node ``i``'s glucose distribution by
    ``skew * offsets[i]``: node 0 sits at ``-skew``, the last node at
    ``+skew``, the population mean shift is exactly zero.  Both the
    sweep engine (batch-level shift inside ``_local_step``) and the
    generator-level skew (:func:`generate_dataset`) use this table, so
    a swept scenario's serial twin is a plain ``train()`` on
    pre-shifted host arrays."""
    if num_nodes <= 1:
        return np.zeros((num_nodes,), np.float32)
    i = np.arange(num_nodes, dtype=np.float32)
    return (2.0 * i - (num_nodes - 1)) / np.float32(num_nodes - 1)


def generate_patient_series(
    spec: DatasetSpec,
    patient: int,
    *,
    days: int | None = None,
    seed: int = 0,
    mean_shift: float = 0.0,
) -> np.ndarray:
    """One patient's CGM trace in mg/dL, shape (days*288,), NaN = missing.

    ``mean_shift`` moves the patient's basal level AFTER all RNG draws
    (no stream is consumed), so ``mean_shift=0.0`` is bitwise-identical
    to the unshifted series."""
    days = spec.num_days if days is None else days
    rng = np.random.default_rng(np.random.SeedSequence([spec.seed_base, patient, seed]))
    n = days * SAMPLES_PER_DAY
    t = np.arange(n) / SAMPLES_PER_DAY  # in days

    # patient-specific latent parameters
    basal = rng.normal(spec.mean_bg, spec.mean_bg_sd) + mean_shift
    target_sd = max(20.0, rng.normal(spec.sd_bg, spec.sd_bg_sd))
    phase = rng.uniform(0, 2 * np.pi)
    circ_amp = rng.uniform(5.0, 15.0)

    g = basal + circ_amp * np.sin(2 * np.pi * t + phase) + 0.4 * circ_amp * np.sin(
        4 * np.pi * t + 1.7 * phase
    )

    # meals: ~3 per day with patient/day jitter; gamma-shaped BG response
    resp_len = 48  # 4 hours of response kernel
    k = np.arange(resp_len, dtype=np.float64)
    rise, decay = 5.0, 14.0
    kernel = (k / rise) ** 2 * np.exp(-k / decay)
    kernel /= kernel.max()
    impulses = np.zeros(n)
    for day in range(days):
        n_meals = max(1, rng.poisson(3))
        if spec.meal_irregularity > 0.8:
            base_times = rng.uniform(0, 1, size=n_meals)
        elif n_meals <= 3:
            # the 3-slot template, jittered: min(n_meals, 3) jitter draws
            base_times = np.array([0.3, 0.55, 0.8])[:n_meals] + rng.normal(
                0, 0.03 * spec.meal_irregularity, size=min(n_meals, 3)
            )
        else:
            base_times = rng.uniform(0.2, 0.9, size=n_meals) + rng.normal(
                0, 0.03 * spec.meal_irregularity, size=n_meals
            )
        assert base_times.shape == (n_meals,), (base_times.shape, n_meals)
        for bt in np.atleast_1d(base_times):
            idx = int((day + float(np.clip(bt, 0, 0.999))) * SAMPLES_PER_DAY)
            amp = rng.gamma(4.0, 20.0) * (0.7 + 0.6 * spec.meal_irregularity)
            impulses[idx] += amp
    meal_bg = np.convolve(impulses, kernel)[:n]

    # insulin-like correction: first-order pull toward basal (stronger for pumps)
    alpha = 0.015 * (1.5 - 0.5 * spec.meal_irregularity)
    corrected = np.empty(n)
    level = 0.0
    excess = meal_bg
    for i in range(n):
        level = level * (1 - alpha) + excess[i] * alpha * 2.2
        corrected[i] = excess[i] - min(level, excess[i] * 0.8)
    g = g + corrected

    # AR(1) sensor/physiology noise
    eps = rng.normal(0, 1, n)
    ar = np.empty(n)
    acc = 0.0
    rho = 0.92
    for i in range(n):
        acc = rho * acc + eps[i]
        ar[i] = acc
    ar *= np.sqrt(1 - rho**2)
    g = g + ar * 12.0

    # rescale to hit the patient's target SD, keep mean
    cur_sd = g.std()
    g = (g - g.mean()) * (target_sd / max(cur_sd, 1e-6)) + basal
    g = np.clip(g, 40.0, 400.0)

    # sensor dropouts: contiguous gaps
    miss = rng.uniform(0, 1, n) < spec.missing_rate / 6
    gap_len = 6
    missing_mask = np.convolve(miss.astype(float), np.ones(gap_len))[:n] > 0
    g[missing_mask] = np.nan
    return g.astype(np.float32)


def generate_dataset(
    name: str,
    *,
    fast: bool = False,
    max_patients: int | None = None,
    seed: int = 0,
    skew: float = 0.0,
) -> list[np.ndarray]:
    """All patients' traces for a dataset.  ``fast`` shortens to 6 days.

    ``skew`` introduces a non-IID per-patient distribution shift:
    patient ``p`` is generated with
    ``mean_shift = skew * mean_bg_sd * node_skew_offsets(n)[p]``.
    ``skew=0.0`` is bitwise-identical to the unskewed dataset (the
    shift is applied after all RNG draws)."""
    spec = DATASET_SPECS[name]
    days = _FAST_DAYS if fast else spec.num_days
    n_pat = spec.num_patients if max_patients is None else min(max_patients, spec.num_patients)
    shifts = float(skew) * spec.mean_bg_sd * node_skew_offsets(n_pat)
    return [
        generate_patient_series(spec, p, days=days, seed=seed, mean_shift=float(shifts[p]))
        for p in range(n_pat)
    ]
