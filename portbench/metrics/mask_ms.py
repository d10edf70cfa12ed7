"""``mask_ms``: device ms a round in the program's ``round.mask`` span,
the where-mask that keeps the inactive rows, the round's loss and the
staleness.  Read from the tracer's CUDA events at the span's ends
(``portbench/spans.py``): elapsed time on the stream, so idle gaps
inside the span count, and it may differ from the device trace's busy
time in the span."""
from portbench.spans import device_ms_per_round


def read(run):
    return device_ms_per_round(run, "round.mask")
