"""Figure 3: 'Personalized Model' (from scratch) vs 'Population Model'
(GluADFL Random) vs 'Personalized from Population' (fine-tuned), per
dataset, evaluated per seen patient.  The counterpart of
``benchmarks/fig3_personalization.py``; the fine-tune is
``core.personalize`` with its batch indices from
``utils.rng.draw_personalize``, and patient i's runs draw from a
generator seeded ``1000 + i`` (where the JAX experiment takes
``PRNGKey(1000 + i)``).

    python -m repro_torch.paper.fig3_personalization [--device cpu] [--full]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from repro_torch.core import personalize, train_supervised
from repro_torch.metrics import all_metrics
from repro_torch.optim import adam
from repro_torch.paper.common import DATASETS, Scale, main, save_json, train_gluadfl
from repro_torch.utils.rng import draw_personalize

FINE_TUNE_BATCH = 32  # the JAX fine-tune's default batch size


def _patient_metrics(model, params, p, fed):
    dev = next(iter(params.values())).device
    with torch.no_grad():
        pred = model.apply(params, torch.as_tensor(p.test_x, device=dev))
    return all_metrics(p.test_y_raw, pred.cpu().numpy() * fed.sd + fed.mean)


def run(scale: Scale | None = None, datasets=None) -> dict:
    scale = scale or Scale()
    datasets = datasets or DATASETS
    dev = scale.torch_device
    out = {}
    for ds in datasets:
        model, pop, _, fed = train_gluadfl(ds, scale, topology="random")
        rows = {"personalized": [], "population": [], "pers_from_pop": []}
        for i, p in enumerate(fed.patients):
            # personalized from scratch
            scratch, _ = train_supervised(
                model, adam(2e-3), scale.generator(1000 + i), p.train_x, p.train_y,
                steps=scale.sup_steps // 4, batch_size=32, device=dev,
            )
            rows["personalized"].append(_patient_metrics(model, scratch, p, fed))
            # population as-is
            rows["population"].append(_patient_metrics(model, pop, p, fed))
            # personalized from population
            rows_ = len(p.train_x)
            idx = draw_personalize(scale.generator(1000 + i), [rows_], rows_,
                                   scale.sup_steps // 8, FINE_TUNE_BATCH)[0]
            pers = personalize(model, adam(5e-4), pop, idx, p.train_x, p.train_y)
            rows["pers_from_pop"].append(_patient_metrics(model, pers, p, fed))
        agg = {
            k: {m: float(np.mean([r[m] for r in v])) for m in v[0]}
            for k, v in rows.items()
        }
        out[ds] = agg
        print(
            f"[{ds:11s}] RMSE personalized {agg['personalized']['rmse']:6.2f} | "
            f"population {agg['population']['rmse']:6.2f} | "
            f"pers-from-pop {agg['pers_from_pop']['rmse']:6.2f} "
            f"(paper: pers-from-pop beats personalized by 0.4-0.8 mg/dL)"
        )
    save_json("fig3_personalization", out)
    return out


if __name__ == "__main__":
    sys.exit(main(run, sys.argv[1:], __doc__.splitlines()[0]))
