"""``optimizer_ms``: device ms a round in the program's
``step.optimizer`` span, every local step's optimizer update (Adam's
passes over the rows' params and state).  Read from the tracer's CUDA
events at the span's ends (``portbench/spans.py``): elapsed time on the
stream, so idle gaps inside the span count."""
from portbench.spans import device_ms_per_round


def read(run):
    return device_ms_per_round(run, "step.optimizer")
