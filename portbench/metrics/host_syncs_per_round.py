"""``host_syncs_per_round``: synchronizing CUDA calls a round in the
round's spans ``round.draws`` through ``round.mask`` and the spans
inside them (``chunk.sync``'s one read a chunk is not among them), as
the tracer counts them from PyTorch's sync debug mode
(``portbench/spans.py``)."""
from portbench.spans import ROUND, snapshot, within


def read(run):
    snap = snapshot(run)
    if snap is None or not set(ROUND) & set(snap):
        return None
    return sum(snap[name].syncs for name in within(snap, ROUND)) / run.traced_rounds
