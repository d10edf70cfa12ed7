"""The glucose servable: checkpoint -> param store -> bucketed forecast
(the counterpart of ``repro.serve.servable``).

:class:`GlucoseServable` owns

  * the **population model** (row 0 of the param store), loaded from a
    federation checkpoint by :func:`load_population`, which infers the
    LSTM width from the flat parameter count;
  * the **param store**: a dict of stacked per-patient parameter rows on
    the servable's device; :meth:`GlucoseServable.personalize` appends
    a cold-start cohort's rows, fine-tuned from the population
    (``core.personalize``, plain PyTorch autograd, as the trainer's
    local step);
  * the **forecast method**: requests are padded to the smallest fitting
    bucket (windows with zeros, param rows with the last real row) and
    run as ONE launch of the ``lstm_forward`` kernel with one weight row
    per request.  A cluster of the kernel runs a tile of up to 8 rows of
    one group, and computes each row in a fixed order that depends on
    neither the batch nor the row's place in its tile, so a forecast is
    bitwise the same whoever shares its batch and padding is inert:
    pinned by ``tests/test_torch_serve.py`` and the launcher's
    ``--selfcheck``.

The batching policy lives in ``serve.batcher``; :func:`replay` is the
deterministic driver that marries the two.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.core.personalize import personalize_batch_fn
from repro_torch.device import resolve_device
from repro_torch.models.base import Model, Params
from repro_torch.optim import Optimizer, adam
from repro_torch.serve.batcher import MicroBatcher, Request, bucket_for
from repro_torch.utils.pytree import tree_to_vector, vector_to_tree
from repro_torch.utils.rng import draw_personalize

# widths the checkpoint loader tries when recovering the LSTM hidden
# size from a flat parameter count
KNOWN_HIDDEN = (4, 8, 16, 32, 64, 128, 256)

DEFAULT_BUCKETS = (1, 4, 16, 64)


def load_population(path, *, hidden: int | None = None, history_len: int = 12) -> tuple[Model, Params]:
    """Load a federation checkpoint (``launch/train.py`` .npz format:
    flat ``vec`` + shape ``meta``) into ``(model, population_params)``,
    the params as float32 CPU tensors.

    With ``hidden=None`` the LSTM width is recovered from the flat
    parameter count (4H² + 4HI + 5H + 1) by trying :data:`KNOWN_HIDDEN`;
    a count matching no known width raises instead of guessing.
    """
    from repro_torch.models import LSTMModel

    vec = torch.from_numpy(np.load(Path(path), allow_pickle=False)["vec"])

    def template(h):
        model = LSTMModel(history_len=history_len, hidden=h)
        return model, model.init(torch.Generator().manual_seed(0))

    if hidden is None:
        for h in KNOWN_HIDDEN:
            model, like = template(h)
            if tree_to_vector(like).numel() == vec.numel():
                return model.as_model(), vector_to_tree(vec, like)
        raise ValueError(
            f"{path}: {vec.numel()} params match no LSTM width in "
            f"{KNOWN_HIDDEN} — pass hidden= explicitly"
        )
    model, like = template(hidden)
    n = tree_to_vector(like).numel()
    if n != vec.numel():
        raise ValueError(f"{path}: {vec.numel()} params but LSTMModel(hidden={hidden}) has {n}")
    return model.as_model(), vector_to_tree(vec, like)


class GlucoseServable:
    """A population model served through padded-bucket batching.

    ``buckets`` are the only batch shapes the forecast launches: a batch
    of n requests runs at the smallest bucket >= n (padded), and batches
    beyond the largest bucket are split.  ``optimizer`` (default Adam at
    5e-4), ``personalize_steps`` and ``personalize_batch_size`` configure
    the cold-start fine-tune (``core.personalize`` semantics: draws with
    replacement from the patient's real windows, the batch clamped to
    short histories).  ``batch_mode`` takes the JAX
    servable's values, ``"map"`` and ``"vmap"``; here both run the same
    batch-independent kernel, so both are bitwise the direct
    :meth:`Model.apply`.  ``device`` defaults to CUDA and raises when no
    GPU is present; pass ``"cpu"`` to run the plain twin on the CPU.
    """

    def __init__(
        self,
        model: Model,
        population_params: Params,
        *,
        optimizer: Optimizer | None = None,
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
        personalize_steps: int = 100,
        personalize_batch_size: int = 32,
        batch_mode: str = "map",
        device=None,
    ):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"need >= 1 positive bucket size, got {buckets!r}")
        if batch_mode not in ("map", "vmap"):
            raise ValueError(f"batch_mode must be 'map' or 'vmap', got {batch_mode!r}")
        self.device = resolve_device(device)
        self.batch_mode = batch_mode
        self.model = model
        self.buckets = buckets
        self.optimizer = optimizer or adam(5e-4)
        self.personalize_steps = personalize_steps
        self.personalize_batch_size = personalize_batch_size
        # param store: row 0 is ALWAYS the population model (the
        # brand-new-patient fallback); personalize() appends rows
        self._store: Params = {
            k: v.to(self.device, torch.float32)[None].contiguous()
            for k, v in population_params.items()
        }
        self._names: dict[object, int] = {"population": 0}
        # padded batch shapes launched so far (introspection for tests/ops)
        self.compiled_buckets: set[int] = set()
        # one fine-tune closure per padded history length M
        self._personalize_fns: dict[int, Callable] = {}
        # (P, steps) losses of the last personalize() call, on the device
        self.personalize_losses: torch.Tensor | None = None

    # --------------------------------------------------------- params
    @property
    def population(self) -> Params:
        return {k: v[0] for k, v in self._store.items()}

    @property
    def num_rows(self) -> int:
        return int(next(iter(self._store.values())).shape[0])

    def row_of(self, name) -> int:
        """Param-store row of a personalized patient (KeyError if the
        patient was never personalized)."""
        return self._names[name]

    def row_of_or_population(self, name) -> int:
        return self._names.get(name, 0)

    def params_rows(self, rows) -> Params:
        """Gather (B,)-indexed param rows from the store: the stack the
        forecast launch reads."""
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        return {k: v.index_select(0, idx) for k, v in self._store.items()}

    # ----------------------------------------------------- personalize
    def personalize(self, names, x, y, counts, *, generator: torch.Generator | None = None,
                    batch_idx=None) -> Params:
        """Cold-start a cohort: fine-tune the population model on each
        patient's own padded history as one batched computation, append
        the personalized rows to the param store, map each name to its
        row (:meth:`row_of`) and return the stacked params.

        ``x`` (P, M, L), ``y`` (P, M) and ``counts`` (P,) follow the
        federation layout.  The minibatch indices come from exactly one
        of ``generator`` (drawn by ``utils.rng.draw_personalize`` on its
        device) and ``batch_idx`` (P, steps, bs), handed in.  One
        fine-tune closure is kept per M."""
        if (generator is None) == (batch_idx is None):
            raise ValueError("personalize takes exactly one of generator= and batch_idx=")
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        m = x.shape[1]
        if m not in self._personalize_fns:
            self._personalize_fns[m] = personalize_batch_fn(
                self.model, self.optimizer, steps=self.personalize_steps,
                batch_size=self.personalize_batch_size, n_rows=m)
        if batch_idx is None:
            batch_idx = draw_personalize(generator, counts, m, self.personalize_steps,
                                         self.personalize_batch_size)
        params, self.personalize_losses = self._personalize_fns[m](
            self.population, batch_idx, x, y)
        base = self.num_rows
        self._store = {k: torch.cat([v, params[k]]) for k, v in self._store.items()}
        for i, name in enumerate(names):
            self._names[name] = base + i
        return params

    # -------------------------------------------------------- forecast
    def _pad_forecast(self, params_batch: Params, windows: torch.Tensor, n: int) -> torch.Tensor:
        b = bucket_for(n, self.buckets)
        if n < b:
            pad = b - n
            windows = torch.cat([windows, windows.new_zeros((pad,) + windows.shape[1:])])
            params_batch = {
                k: torch.cat([v, v[-1:].expand((pad,) + v.shape[1:])])
                for k, v in params_batch.items()
            }
        self.compiled_buckets.add(b)
        return self.model.apply_rows(params_batch, windows)[:n]

    def forecast(self, params_batch: Params, windows) -> torch.Tensor:
        """BG forecasts for a batch of (per-request params row, CGM
        window) pairs, padded to the smallest fitting bucket; batches
        larger than the biggest bucket are split into full-bucket
        chunks.  Returns the (B,) normalized forecasts on the servable's
        device (denormalize with the dataset's mean/sd for mg/dL)."""
        windows = torch.as_tensor(windows, dtype=torch.float32, device=self.device)
        if windows.dim() != 2:
            raise ValueError(f"windows must be (B, L), got {tuple(windows.shape)}")
        n = windows.shape[0]
        cap = self.buckets[-1]
        if n <= cap:
            return self._pad_forecast(params_batch, windows, n)
        outs = []
        for lo in range(0, n, cap):
            hi = min(lo + cap, n)
            chunk = {k: v[lo:hi] for k, v in params_batch.items()}
            outs.append(self._pad_forecast(chunk, windows[lo:hi], hi - lo))
        return torch.cat(outs)

    def forecast_rows(self, rows, windows) -> torch.Tensor:
        """Convenience: gather store rows, then :meth:`forecast`."""
        return self.forecast(self.params_rows(rows), windows)

    def warmup(self, history_len: int = 12) -> None:
        """Run every bucket once, so the first real request pays no
        kernel build or first-launch cost."""
        for b in self.buckets:
            self._pad_forecast(
                self.params_rows([0] * b),
                torch.zeros((b, history_len), dtype=torch.float32, device=self.device),
                b,
            )


def replay(
    servable: GlucoseServable,
    batcher: MicroBatcher,
    requests: Iterable[Request],
    *,
    drain: bool = True,
) -> dict[int, float]:
    """Deterministic serving loop: submit the request stream in order,
    run every batch the batcher forms (pad-to-bucket inside
    ``servable.forecast``), and return ``{rid: forecast}``.

    Batches execute synchronously as they form (each ends in a copy to
    the host), so ``max_live_batches`` never blocks here.  With
    ``drain=True`` the queued tail is flushed after the stream ends,
    timeout or not.
    """
    preds: dict[int, float] = {}

    def run(batch):
        rows = [r.patient for r in batch]
        windows = np.stack([r.window for r in batch])
        out = servable.forecast_rows(rows, windows).cpu().numpy()
        batcher.complete(batch)
        for r, p in zip(batch, out):
            preds[r.rid] = float(p)

    for req in requests:
        batcher.submit(req)
        while (batch := batcher.ready()) is not None:
            run(batch)
    while drain and (batch := batcher.flush()) is not None:
        run(batch)
    return preds
