"""``eval_ms``: device ms an eval round of the work the trainer's
``round.eval`` span launched (the populations and their val RMSE)."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.traced_evals:
        return None
    return run.trace.span_ms["round.eval"] / run.traced_evals
