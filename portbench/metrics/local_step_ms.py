"""``local_step_ms``: device ms a round of the work the trainer's
``round.local_step`` span launched (the LSTM forward and backward over
every row's batch, Adam)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.traced_rounds:
        return None
    return run.trace.span_ms["round.local_step"] / run.traced_rounds
