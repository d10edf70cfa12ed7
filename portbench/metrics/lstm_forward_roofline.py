"""``lstm_forward_roofline``: the least time the traced evals'
``lstm_forward`` launches could take on the card (``costs.bound_s`` of
the operations and bytes their shapes need) over the device time of the
kernels named ``lstm_forward*``, in %."""
from portbench.costs import bound_s, lstm_forward_cost


def read(run):
    if run.trace is None or not run.traced_evals:
        return None
    ms, launches = run.trace.kernels(lambda name: "lstm_forward" in name)
    if not launches or ms <= 0:
        return None
    need = run.traced_evals * sum(bound_s(*lstm_forward_cost(*shape))
                                  for shape in run.eval_launches)
    return 100.0 * need * 1e3 / ms
