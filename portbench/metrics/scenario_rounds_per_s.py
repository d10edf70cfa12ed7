"""``scenario_rounds_per_s``: the scenario-rounds the window completed
over its seconds on the host clock, whole chunks of the engine with
their evals and host syncs (a swept round of G scenarios counts G)."""


def read(run):
    return run.scenario_rounds / run.window_s
