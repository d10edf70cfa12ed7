"""``round_mfu``: the model FLOPs the traced window required over its
seconds, as a share of the card's fp32 peak (TF32 off, as the
configurations run), in %.  Required: forward and backward of every
window of the ACTIVE rows' batches (from the benchmark's own draws) and
one forward of every eval window of each population; gossip and the
optimizer are bound by bandwidth and left out (``costs.train_flops``)."""
from portbench.costs import FP32_OPS_PER_S, train_flops, window_flops


def read(run):
    if run.trace is None or run.trace.busy_s <= 0 or not run.active_rows:
        return None
    model, traffic = run.cell.config["model"], run.cell.traffic
    shape = (model["history_len"], model["input_size"], model["hidden"])
    flops = sum(train_flops(sum(active), traffic["batch_size"], traffic["local_steps"], *shape)
                for active in run.active_rows)
    flops += run.traced_evals * sum(g * r * window_flops(*shape)
                                    for g, r, *_ in run.eval_launches)
    return 100.0 * flops / run.window_s / FP32_OPS_PER_S
