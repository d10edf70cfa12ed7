"""The port's tracer (``repro_torch.utils.tracing``): a tiny
``GluADFL.train`` under ``torch.profiler`` arms it (each round span once
a round, the local step's ``step.*`` spans once a local step inside
``round.local_step``, children's host time inside their parent's, one
``chunk.sync`` a chunk); without a profiler it records nothing, and
armed or not the loss history is bitwise the same.  On the card (marker
``gpu``): every span's device time, one sync counted for a deliberate
``.item()`` and none for a span without one, and no sync-debug report
on stderr.  These tests import neither ``jax`` nor ``repro``:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_tracing.py
"""
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.config import FLConfig
from repro_torch.core import GluADFL
from repro_torch.models import LSTMModel
from repro_torch.optim import adam
from repro_torch.utils import tracing

N, H, ROUNDS, CHUNK, LOCAL_STEPS, EVAL_EVERY = 8, 16, 4, 2, 2, 2
ROUND_SPANS = ("round.draws", "round.mixing_operator", "round.gossip", "round.local_step",
               "round.mask")
STEP_SPANS = ("step.forward", "step.backward", "step.optimizer")


@pytest.fixture(autouse=True)
def fresh_tracer():
    tracing.reset()
    yield
    tracing.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _train(device, profiled: bool):
    """The loss history of a tiny federation trained under a profiler
    (CPU activity, and CUDA on the card) or without one."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, 32, 12)).astype(np.float32)
    y = (0.8 * x[:, :, -1] + 0.1 * rng.normal(size=(N, 32))).astype(np.float32)
    counts = np.full(N, 32, np.int32)
    trainer = GluADFL(LSTMModel(hidden=H).as_model(), adam(1e-3),
                      FLConfig(num_nodes=N, inactive_ratio=0.3, local_steps=LOCAL_STEPS),
                      device=device)

    def run():
        _, hist, _ = trainer.train(torch.Generator(device=device).manual_seed(0), x, y, counts,
                                   batch_size=4, rounds=ROUNDS, chunk=CHUNK,
                                   eval_every=EVAL_EVERY, val_data=(x[0], y[0]))
        return hist
    if not profiled:
        return run()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts):
        return run()


def test_armed_spans_of_a_tiny_train():
    _train(torch.device("cpu"), profiled=True)
    snap = tracing.snapshot()
    for name in ROUND_SPANS:
        assert snap[name].calls == ROUNDS and snap[name].parents == {None: ROUNDS}, name
    assert snap["round.eval"].calls == ROUNDS // EVAL_EVERY
    assert snap["chunk.sync"].calls == ROUNDS // CHUNK
    for name in STEP_SPANS:
        stats = snap[name]
        assert stats.calls == ROUNDS * LOCAL_STEPS, name
        assert stats.parents == {"round.local_step": ROUNDS * LOCAL_STEPS}, name
    parent = snap["round.local_step"]
    children = sum(snap[name].host_ms for name in STEP_SPANS)
    assert 0 < children <= parent.host_ms
    assert parent.self_host_ms == pytest.approx(parent.host_ms - children, abs=1e-6)
    for stats in snap.values():
        assert 0 <= stats.self_host_ms <= stats.host_ms
        if not torch.cuda.is_initialized():  # no card: no device time and no syncs
            assert stats.device_ms is None and stats.syncs == 0


def test_unprofiled_train_records_nothing():
    _train(torch.device("cpu"), profiled=False)
    assert tracing.snapshot() == {}


def test_loss_history_bitwise_armed_and_disarmed():
    armed = _train(torch.device("cpu"), profiled=True)
    disarmed = _train(torch.device("cpu"), profiled=False)
    assert armed == disarmed and len(armed) == ROUNDS


def test_self_time_parents_and_reset():
    """Nested spans on the host clock: a parent's self time leaves out
    its child's; a span opened outside any has no parent; ``reset``
    empties the aggregates."""
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer"):
            time.sleep(0.02)
            with tracing.span("inner"):
                time.sleep(0.03)
    snap = tracing.snapshot()
    outer, inner = snap["outer"], snap["inner"]
    assert outer.parents == {None: 1} and inner.parents == {"outer": 1}
    assert inner.host_ms >= 30 and outer.host_ms >= inner.host_ms + 20
    assert outer.self_host_ms == pytest.approx(outer.host_ms - inner.host_ms, abs=1e-6)
    tracing.reset()
    assert tracing.snapshot() == {}


def test_a_span_still_names_the_profile():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("named.region"):
            torch.ones(4).sum()
    assert any(e.name == "named.region" for e in prof.events())


@pytest.mark.gpu
def test_device_time_of_every_span_on_the_card(cuda):
    _train(cuda, profiled=True)
    snap = tracing.snapshot()
    assert set(ROUND_SPANS + STEP_SPANS + ("round.eval", "chunk.sync")) <= set(snap)
    for name, stats in snap.items():
        assert stats.device_ms is not None and stats.device_ms >= 0, name
    steps = sum(snap[name].device_ms for name in STEP_SPANS)
    assert 0 < steps <= snap["round.local_step"].device_ms
    assert snap["chunk.sync"].syncs >= ROUNDS // CHUNK


@pytest.mark.gpu
def test_host_syncs_counted_by_span_on_the_card(cuda, capfd):
    before = torch.cuda.get_sync_debug_mode()
    x = torch.ones(1024, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with tracing.span("test.sync"):
            value = (x * 2).sum().item()
            with tracing.span("test.none"):
                y = x * 3 + 1
        with pytest.warns(UserWarning, match="passes through"):
            with tracing.span("test.other_warning"):
                warnings.warn("passes through")
    torch.cuda.synchronize()
    snap = tracing.snapshot()
    assert value == 2048.0 and float(y[0]) == 4.0
    assert snap["test.sync"].syncs == 1
    assert snap["test.none"].syncs == 0 and snap["test.none"].parents == {"test.sync": 1}
    assert snap["test.other_warning"].syncs == 0
    assert torch.cuda.get_sync_debug_mode() == before
    assert tracing.SYNC_REPORT not in capfd.readouterr().err
