"""The readers of the program's own spans (``portbench/spans.py`` and
the six metrics on it) against a hand-made tracer snapshot and a fake
run: what each reads a round, and None wherever the run traced no card
or the snapshot lacks what the metric needs."""
from types import SimpleNamespace

import pytest

from portbench_tiny import PB

from portbench import spec
from repro_torch.utils import tracing
from repro_torch.utils.tracing import SpanStats

ROUNDS = 4
SNAP = {
    "round.draws": SpanStats(calls=4, host_ms=2.0, device_ms=0.4),
    "round.mixing_operator": SpanStats(calls=4, host_ms=12.0, device_ms=1.0, syncs=4),
    "round.gossip": SpanStats(calls=4, host_ms=4.0, device_ms=8.0),
    "round.secure_mask": SpanStats(calls=4, host_ms=1.0, device_ms=2.0, syncs=2,
                                   parents={"round.gossip": 4}),
    "round.local_step": SpanStats(calls=4, host_ms=20.0, device_ms=400.0),
    "step.forward": SpanStats(calls=4, host_ms=6.0, device_ms=120.0,
                              parents={"round.local_step": 4}),
    "step.backward": SpanStats(calls=4, host_ms=8.0, device_ms=200.0, syncs=1,
                               parents={"round.local_step": 4}),
    "step.optimizer": SpanStats(calls=4, host_ms=3.0, device_ms=60.0,
                                parents={"round.local_step": 4}),
    "round.mask": SpanStats(calls=4, host_ms=2.0, device_ms=12.0),
    "round.eval": SpanStats(calls=1, host_ms=50.0, device_ms=9.0, syncs=3),
    "chunk.sync": SpanStats(calls=2, host_ms=90.0, device_ms=0.1, syncs=2),
}
WANT = {"forward_ms": 30.0, "backward_ms": 50.0, "optimizer_ms": 15.0, "mask_ms": 3.0,
        "host_round_ms": (2 + 12 + 4 + 20 + 2) / 4, "host_syncs_per_round": (4 + 2 + 1) / 4}


def _reader(name):
    return spec.load_module(PB / "metrics" / f"{name}.py", f"metric_{name}").read


def _run(busy_s=1.0, rounds=ROUNDS, traced=True):
    return SimpleNamespace(trace=SimpleNamespace(busy_s=busy_s) if traced else None,
                           traced_rounds=rounds)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reads_a_round_of_the_snapshot(monkeypatch, name):
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAP)
    assert _reader(name)(_run()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_without_a_traced_card(monkeypatch, name):
    monkeypatch.setattr(tracing, "snapshot", lambda: SNAP)
    read = _reader(name)
    assert read(_run(traced=False)) is None
    assert read(_run(busy_s=0.0)) is None
    assert read(_run(rounds=0)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_none_where_the_snapshot_lacks_it(monkeypatch, name):
    """A snapshot of the CPU (no device time) or of a program whose
    rounds opened no span."""
    cpu = {k: SpanStats(calls=s.calls, host_ms=s.host_ms, parents=s.parents)
           for k, s in SNAP.items()}
    monkeypatch.setattr(tracing, "snapshot", lambda: {})
    assert _reader(name)(_run()) is None
    monkeypatch.setattr(tracing, "snapshot", lambda: cpu)
    if name.startswith("host_"):
        assert _reader(name)(_run()) is not None
    else:
        assert _reader(name)(_run()) is None
