"""The program's own spans (``repro_torch.utils.tracing``) as the
per-layer metrics read them.  The tracer arms itself while a
``torch.profiler`` session records, so after a traced run its
aggregates cover the traced window's rounds and nothing else the
process ran.  A run that traced no card, or a program without the
tracer (an older commit), gives None."""
from __future__ import annotations

# a round's top-level spans before its eval and the chunk's sync, in a round's order
ROUND = ("round.draws", "round.mixing_operator", "round.gossip", "round.local_step",
         "round.mask")


def snapshot(run) -> dict | None:
    """The tracer's aggregates by span name, or None."""
    if run.trace is None or run.trace.busy_s <= 0 or not run.traced_rounds:
        return None
    try:
        from repro_torch.utils import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def device_ms_per_round(run, name: str) -> float | None:
    """Device ms a traced round inside the span ``name``."""
    snap = snapshot(run)
    stats = None if snap is None else snap.get(name)
    if stats is None or stats.device_ms is None:
        return None
    return stats.device_ms / run.traced_rounds


def within(snap: dict, tops) -> set[str]:
    """The names of ``tops`` and of every span opened inside one of them."""
    names = set(tops) & set(snap)
    while True:
        more = {name for name, stats in snap.items()
                if name not in names and names.intersection(stats.parents)}
        if not more:
            return names
        names |= more
