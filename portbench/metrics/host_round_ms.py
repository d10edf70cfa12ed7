"""``host_round_ms``: host ms a round in the round's top-level spans
before its eval (``round.draws`` through ``round.mask``), from the
tracer's clock (``portbench/spans.py``): the host's enqueue and every
blocking wait inside them."""
from portbench.spans import ROUND, snapshot


def read(run):
    snap = snapshot(run)
    if snap is None or not set(ROUND) & set(snap):
        return None
    return sum(snap[name].host_ms for name in ROUND if name in snap) / run.traced_rounds
