"""The port's serving slice against the JAX package's: checkpoint
loading (the committed H=8 checkpoint and an H=128 one written by the
JAX launcher), forecasts within ``atol=1e-5`` of the JAX servable's, the
bitwise padding/batching contract on the CPU path, the param store's
personalized rows, the MicroBatcher policy step for step under one fake
clock, and the CLI (with a personalized cohort).

The forecasts differ from JAX's only in fp32 summation order (~1e-7
over 12 recurrent steps), hence ``atol=1e-5``.  Everything runs with
``device="cpu"``; ``tests/test_torch_gpu.py`` repeats the bitwise
contract through the CUDA kernel.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve.batcher as tbatcher
from repro.launch.train import save_checkpoint
from repro.models import LSTMModel as JaxLSTM
from repro_torch.launch import serve as serve_cli
from repro_torch.models import params_from_numpy
from repro_torch.serve import GlucoseServable, MicroBatcher, Request, load_population, replay
from repro_torch.utils.pytree import tree_to_vector

pytestmark = pytest.mark.serve

ROOT = Path(__file__).resolve().parents[1]
CKPT = ROOT / "experiments" / "checkpoints" / "gluadfl_ohiot1dm_ring.npz"
L = 12
ATOL = 1e-5


def _windows(n, seed):
    return np.random.default_rng(seed).normal(size=(n, L)).astype(np.float32)


def _rows(hidden, seeds):
    """Distinct per-request param rows, stacked, from JAX inits."""
    rows = [JaxLSTM(hidden=hidden).init(jax.random.PRNGKey(s)) for s in seeds]
    return params_from_numpy({k: np.stack([np.asarray(r[k]) for r in rows]) for k in rows[0]}, "cpu")


@pytest.fixture(scope="module")
def servable():
    model, pop = load_population(CKPT)
    return GlucoseServable(model, pop, buckets=(1, 2, 4), device="cpu")


# ------------------------------------------------------------------- (e)


def test_load_population_committed_checkpoint_matches_jax():
    jmodel, jpop = jserve.load_population(CKPT)
    model, pop = load_population(CKPT)
    assert set(pop) == set(jpop)
    for k in jpop:
        assert pop[k].dtype == torch.float32
        np.testing.assert_array_equal(pop[k].numpy(), np.asarray(jpop[k]))
    np.testing.assert_array_equal(tree_to_vector(pop).numpy(), np.load(CKPT)["vec"])
    windows = _windows(7, seed=0)
    want = jserve.GlucoseServable(jmodel, jpop, buckets=(1, 4)).forecast_rows([0] * 7, windows)
    got = GlucoseServable(model, pop, buckets=(1, 4), device="cpu").forecast_rows([0] * 7, windows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_load_population_h128_from_the_jax_launcher_matches_jax(tmp_path):
    path = tmp_path / "h128.npz"
    save_checkpoint(path, JaxLSTM(hidden=128).init(jax.random.PRNGKey(3)))
    jmodel, jpop = jserve.load_population(path)
    model, pop = load_population(path)
    assert pop["wh"].shape == (128, 512) and tree_to_vector(pop).numel() == 66_689
    for k in jpop:
        np.testing.assert_array_equal(pop[k].numpy(), np.asarray(jpop[k]))
    windows = _windows(5, seed=1)
    want = jserve.GlucoseServable(jmodel, jpop, buckets=(4,)).forecast_rows([0] * 5, windows)
    got = GlucoseServable(model, pop, buckets=(4,), device="cpu").forecast_rows([0] * 5, windows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_load_population_rejects_wrong_hidden_and_unknown_count(tmp_path):
    with pytest.raises(ValueError, match="hidden=64"):
        load_population(CKPT, hidden=64)
    bogus = tmp_path / "bogus.npz"
    np.savez(bogus, vec=np.zeros(17, np.float32), meta="{}")
    with pytest.raises(ValueError, match="no LSTM width"):
        load_population(bogus)


# ------------------------------------------------------------------- (f)


def test_bucket_padding_never_changes_real_forecasts(servable):
    """Every batch size n <= the largest bucket returns bitwise the
    n=1 forecasts, per-request rows and pad rows and all."""
    params = _rows(8, seeds=range(4))
    windows = _windows(4, seed=2)
    singles = [servable.forecast({k: v[i : i + 1] for k, v in params.items()}, windows[i : i + 1])[0]
               for i in range(4)]
    for n in (1, 2, 3, 4):
        batched = servable.forecast({k: v[:n] for k, v in params.items()}, windows[:n])
        assert torch.equal(batched, torch.stack(singles[:n])), f"batch of {n}"


def test_oversized_batch_splits_on_largest_bucket(servable):
    n = 4 * 2 + 3  # two full largest buckets + a padded tail
    params = _rows(8, seeds=range(n))
    windows = _windows(n, seed=3)
    out = servable.forecast(params, windows)
    singles = torch.stack([
        servable.forecast({k: v[i : i + 1] for k, v in params.items()}, windows[i : i + 1])[0]
        for i in range(n)
    ])
    assert torch.equal(out, singles)


@pytest.mark.parametrize("batch_mode", ["map", "vmap"])
def test_served_equals_direct_apply_bitwise(batch_mode):
    model, pop = load_population(CKPT)
    sv = GlucoseServable(model, pop, buckets=(1, 4, 16), batch_mode=batch_mode, device="cpu")
    windows = _windows(23, seed=4)
    reqs = [Request(rid=i, patient=0, window=w) for i, w in enumerate(windows)]
    preds = replay(sv, MicroBatcher(sv.buckets), reqs)
    assert sorted(preds) == list(range(23))
    assert serve_cli.selfcheck(sv, reqs, preds) == 0
    for r in reqs:
        assert preds[r.rid] == float(model.apply(pop, torch.from_numpy(r.window)[None])[0])


def test_served_matches_jax_servable_on_a_request_stream(servable):
    jmodel, jpop = jserve.load_population(CKPT)
    jsv = jserve.GlucoseServable(jmodel, jpop, buckets=(1, 2, 4))
    reqs = [Request(rid=i, patient=0, window=w) for i, w in enumerate(_windows(13, seed=5))]
    got = replay(servable, MicroBatcher(servable.buckets), reqs)
    want = jserve.replay(jsv, jserve.MicroBatcher(jsv.buckets),
                         [jserve.Request(rid=r.rid, patient=0, window=r.window) for r in reqs])
    np.testing.assert_allclose([got[i] for i in range(13)], [want[i] for i in range(13)],
                               rtol=0, atol=ATOL)


def test_warmup_launches_exactly_the_buckets(servable):
    servable.warmup(history_len=L)
    assert servable.compiled_buckets == set(servable.buckets)
    for n in (1, 2, 3, 4, 7):
        servable.forecast_rows([0] * n, _windows(n, seed=n))
    assert servable.compiled_buckets == set(servable.buckets)


def test_store_rows_of_personalized_patients(servable):
    """A personalized cohort's rows join the store under their names;
    the population keeps row 0 and unknown names fall back to it."""
    assert servable.num_rows == 1
    assert servable.row_of_or_population("never-seen") == 0
    with pytest.raises(KeyError):
        servable.row_of("never-seen")
    with pytest.raises(ValueError, match="batch_mode"):
        GlucoseServable(servable.model, servable.population, batch_mode="scan", device="cpu")
    sv = GlucoseServable(servable.model, servable.population, buckets=(1, 4),
                         personalize_steps=5, device="cpu")
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 10, L)).astype(np.float32)
    y = x[:, :, -1].copy()
    params = sv.personalize(["new-a", "new-b"], x, y, np.array([10, 4]),
                            generator=torch.Generator().manual_seed(0))
    assert sv.num_rows == 3 and sv.row_of("new-a") == 1 and sv.row_of("new-b") == 2
    assert sv.row_of_or_population("new-b") == 2
    assert all(torch.equal(sv.population[k], servable.population[k]) for k in params)
    windows = _windows(3, seed=13)
    served = sv.forecast_rows([1, 2, 0], windows)
    for i, row in enumerate((0, 1)):
        direct = sv.model.apply({k: v[row] for k, v in params.items()},
                                torch.from_numpy(windows[i : i + 1]))
        assert torch.equal(served[i : i + 1], direct)
    assert torch.equal(served[2:], sv.model.apply(sv.population, torch.from_numpy(windows[2:])))


# ------------------------------------------------------------------- (g)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(mod, seed):
    """A seeded random script of submit / ready / flush / complete /
    fail against one batcher module; returns what it observed."""
    clock = FakeClock()
    mb = mod.MicroBatcher((1, 2, 4), max_live_batches=2, flush_timeout=0.01, clock=clock)
    rng = np.random.default_rng(seed)
    live, log, rid = [], [], 0
    for _ in range(300):
        clock.t += float(rng.uniform(0, 0.004))
        op = int(rng.integers(0, 5))
        if op <= 1:
            mb.submit(mod.Request(rid=rid, patient=0, window=np.zeros(L, np.float32)))
            rid += 1
        elif op == 2:
            batch = mb.ready() if rng.uniform() < 0.7 else mb.flush()
            log.append(None if batch is None else [r.rid for r in batch])
            if batch is not None:
                live.append(batch)
        elif live:
            batch = live.pop(0)
            if op == 3:
                mb.complete(batch)
            else:
                mb.fail(batch, requeue=bool(rng.integers(0, 2)))
        log.append((mb.pending, mb.live_batches))
    return log, mb.stats()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batcher_matches_jax_batcher_under_one_fake_clock(seed):
    from repro.serve import batcher as jbatcher

    log_t, stats_t = _drive(tbatcher, seed)
    log_j, stats_j = _drive(jbatcher, seed)
    assert log_t == log_j
    assert stats_t["completed"] > 0 and stats_t["failed_batches"] > 0
    np.testing.assert_equal(stats_t, stats_j)
    assert tbatcher.bucket_for(3, (1, 4)) == jbatcher.bucket_for(3, (1, 4)) == 4


# ------------------------------------------------------------------- (h)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", *args],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)


def test_launcher_selfcheck_passes_on_cpu():
    out = _cli("--device", "cpu", "--selfcheck", "--requests", "64")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "64/64 served forecasts bitwise-match" in out.stdout


def test_launcher_serves_fresh_init_population():
    out = _cli("--device", "cpu", "--init-hidden", "16", "--init-seed", "2",
               "--buckets", "1,4", "--requests", "9", "--selfcheck")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "hidden=16" in out.stdout and "9/9 served" in out.stdout


def test_launcher_personalize_selfcheck_passes_on_cpu():
    out = _cli("--device", "cpu", "--personalize", "2", "--selfcheck", "--requests", "64",
               "--steps", "10")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "personalized 2 cold-start patients (10 steps on <= 24 windows each)" in out.stdout
    assert "64/64 served forecasts bitwise-match" in out.stdout


# ------------------------------------------------------------------- (i)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, pop = load_population(CKPT)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GlucoseServable(model, pop)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--requests", "4"])
