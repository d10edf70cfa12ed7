"""Table 2: generalization of GluADFL(Random) population models --
train on each dataset, evaluate on ALL datasets (diagonal = seen
patients, off-diagonal = unseen / cross-prediction).  The counterpart of
``benchmarks/table2_generalization.py``.

    python -m repro_torch.paper.table2_generalization [--device cpu] [--full]
"""
from __future__ import annotations

import sys

from repro_torch.paper.common import (
    DATASETS,
    Scale,
    eval_population,
    load,
    main,
    print_metric_table,
    save_json,
    train_gluadfl,
)


def run(scale: Scale | None = None) -> dict:
    scale = scale or Scale()
    rows = {}
    for train_ds in DATASETS:
        model, pop, _, _ = train_gluadfl(train_ds, scale, topology="random")
        rows[train_ds] = {
            test_ds: eval_population(model, pop, load(test_ds, scale))
            for test_ds in DATASETS
        }
    print_metric_table("Table 2 — GluADFL(Random) population generalization", rows)
    # the paper's headline check: unseen-vs-seen RMSE gap
    gaps = []
    for tr in DATASETS:
        seen = rows[tr][tr]["rmse"]
        for te in DATASETS:
            if te != tr:
                gaps.append(rows[tr][te]["rmse"] - seen)
    summary = {"rows": rows, "mean_unseen_minus_seen_rmse": float(sum(gaps) / len(gaps))}
    print(f"\nmean unseen-seen RMSE gap: {summary['mean_unseen_minus_seen_rmse']:.2f} mg/dL "
          "(paper: <=0.5 for 78% of metrics)")
    save_json("table2_generalization", summary)
    return summary


if __name__ == "__main__":
    sys.exit(main(run, sys.argv[1:], __doc__.splitlines()[0]))
