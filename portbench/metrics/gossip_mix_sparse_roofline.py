"""``gossip_mix_sparse_roofline``: the least time the traced rounds'
sparse gossip mixes could take on the card (``costs.bound_s`` of each
round's mix of the (N, D) params over the (N, B+1) table, its active
rows from the benchmark's draws) over the device time of the sparse,
non-DP ``gossip_mix`` kernels, in %."""
import re

from portbench.costs import bound_s, gossip_mix_sparse_cost

KERNEL = re.compile(r"gossip_mix\w*<true, false>")


def read(run):
    if run.trace is None or not run.active_rows:
        return None
    ms, launches = run.trace.kernels(lambda name: KERNEL.search(name) is not None)
    if not launches or ms <= 0:
        return None
    model, fed = run.cell.config["model"], run.cell.config["federation"]
    hsz, isz = model["hidden"], model["input_size"]
    d = 4 * hsz * (isz + hsz + 1) + hsz + 1
    slots = min(fed["comm_batch"], run.nodes - 1) + 1
    need = sum(bound_s(*gossip_mix_sparse_cost(run.nodes, d, slots, sum(active)))
               for active in run.active_rows)
    return 100.0 * need * 1e3 / ms
