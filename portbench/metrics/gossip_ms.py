"""``gossip_ms``: device ms a round of the work the trainer's
``round.gossip`` span launched (the mix of the (G·N, D) params)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.traced_rounds:
        return None
    return run.trace.span_ms["round.gossip"] / run.traced_rounds
