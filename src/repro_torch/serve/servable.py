"""The glucose servable: checkpoint -> param store -> bucketed forecast
(the counterpart of ``repro.serve.servable``).

:class:`GlucoseServable` owns

  * the **population model** (row 0 of the param store), loaded from a
    federation checkpoint by :func:`load_population`, which infers the
    LSTM width from the flat parameter count;
  * the **param store**: a dict of stacked per-patient parameter rows on
    the servable's device;
  * the **forecast method**: requests are padded to the smallest fitting
    bucket (windows with zeros, param rows with the last real row) and
    run as ONE launch of the ``lstm_forward`` kernel with one weight row
    per request.  A cluster of the kernel runs a tile of up to 8 rows of
    one group, and computes each row in a fixed order that depends on
    neither the batch nor the row's place in its tile, so a forecast is
    bitwise the same whoever shares its batch and padding is inert:
    pinned by ``tests/test_torch_serve.py`` and the launcher's
    ``--selfcheck``.

Cold-start personalization (``repro.core.personalize``) is not ported
yet; it will fine-tune through the same plain-PyTorch autograd path the
trainer uses, and until then :meth:`GlucoseServable.personalize` raises.

The batching policy lives in ``serve.batcher``; :func:`replay` is the
deterministic driver that marries the two.
"""
from __future__ import annotations

from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.base import Model, Params
from repro_torch.serve.batcher import MicroBatcher, Request, bucket_for
from repro_torch.utils.pytree import tree_to_vector, vector_to_tree

# widths the checkpoint loader tries when recovering the LSTM hidden
# size from a flat parameter count
KNOWN_HIDDEN = (4, 8, 16, 32, 64, 128, 256)

DEFAULT_BUCKETS = (1, 4, 16, 64)

PERSONALIZE_PENDING = (
    "cold-start personalization is not ported to PyTorch yet; it waits on "
    "core/personalize.py over the trainer's autograd path"
)


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
    beyond the largest bucket are split.  ``batch_mode`` takes the JAX
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
        buckets: tuple[int, ...] = DEFAULT_BUCKETS,
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
        # param store: row 0 is ALWAYS the population model (the
        # brand-new-patient fallback)
        self._store: Params = {
            k: v.to(self.device, torch.float32)[None].contiguous()
            for k, v in population_params.items()
        }
        self._names: dict[object, int] = {"population": 0}
        # padded batch shapes launched so far (introspection for tests/ops)
        self.compiled_buckets: set[int] = set()

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
    def personalize(self, names, keys, x, y, counts) -> Params:
        """Not yet available in the port (see :data:`PERSONALIZE_PENDING`)."""
        raise NotImplementedError(PERSONALIZE_PENDING)

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
