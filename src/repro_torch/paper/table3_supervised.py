"""Table 3: generalization of population models trained by MIXING data
(traditional supervised learning) -- the privacy-free comparator for
Table 2.  The counterpart of ``benchmarks/table3_supervised.py``.

    python -m repro_torch.paper.table3_supervised [--device cpu] [--full]
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
    train_mixed_supervised,
)


def run(scale: Scale | None = None) -> dict:
    scale = scale or Scale()
    rows = {}
    for train_ds in DATASETS:
        model, params, _, _ = train_mixed_supervised(train_ds, scale)
        rows[train_ds] = {
            test_ds: eval_population(model, params, load(test_ds, scale))
            for test_ds in DATASETS
        }
    print_metric_table("Table 3 — mixed-data supervised generalization", rows)
    save_json("table3_supervised", {"rows": rows})
    return {"rows": rows}


if __name__ == "__main__":
    sys.exit(main(run, sys.argv[1:], __doc__.splitlines()[0]))
