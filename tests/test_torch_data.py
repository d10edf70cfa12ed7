"""The port's numpy copy of the data layer gives bitwise the same arrays
as ``repro.data``: the synthetic series, the windowing helpers and the
federated loader, for every dataset twin at the fast (6-day) scale."""
import dataclasses

import numpy as np
import pytest

import repro.data as jd
import repro.data.synth as jsynth
import repro_torch.data as td
import repro_torch.data.synth as tsynth


def _assert_same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["ohiot1dm", "abc4d", "ctr3", "replace-bg"])
def test_load_federated_dataset_is_bitwise_the_jax_packages(name):
    want = jd.load_federated_dataset(name, fast=True)
    got = td.load_federated_dataset(name, fast=True)
    assert got.name == want.name and got.num_nodes == want.num_nodes
    assert (got.mean, got.sd) == (want.mean, want.sd)
    for field in ("x", "y", "counts"):
        _assert_same(getattr(got, field), getattr(want, field))
    for pg, pw in zip(got.patients, want.patients):
        for f in dataclasses.fields(pw):
            a, b = getattr(pg, f.name), getattr(pw, f.name)
            if isinstance(b, np.ndarray):
                _assert_same(a, b)
            else:
                assert a == b, f.name


def test_generator_with_skew_and_seed_is_bitwise_the_jax_packages():
    want = jsynth.generate_dataset("ohiot1dm", fast=True, max_patients=4, seed=3, skew=0.5)
    got = tsynth.generate_dataset("ohiot1dm", fast=True, max_patients=4, seed=3, skew=0.5)
    for a, b in zip(got, want):
        _assert_same(a, b)
    _assert_same(tsynth.node_skew_offsets(7), jsynth.node_skew_offsets(7))


def test_windowing_helpers_match():
    rng = np.random.default_rng(0)
    series = (150 + 40 * rng.normal(size=500)).astype(np.float32)
    series[rng.uniform(size=500) < 0.05] = np.nan
    for a, b in zip(td.split_by_time(series), jd.split_by_time(series)):
        _assert_same(a, b)
    stats = td.zscore_stats([series[:200], series[200:]])
    assert stats == jd.zscore_stats([series[:200], series[200:]])
    norm = td.normalize(series, *stats)
    _assert_same(norm, jd.normalize(series, *stats))
    for a, b in zip(td.make_windows(norm, series, 12, 6), jd.make_windows(norm, series, 12, 6)):
        _assert_same(a, b)


def test_batch_iterator_matches():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.float32)
    it_t, it_j = td.batch_iterator(x, y, 6, seed=4), jd.batch_iterator(x, y, 6, seed=4)
    for _ in range(7):
        (xt, yt), (xj, yj) = next(it_t), next(it_j)
        _assert_same(xt, xj)
        _assert_same(yt, yj)
