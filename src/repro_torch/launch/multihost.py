"""Multi-process federation bootstrap over ``torch.distributed`` (the
counterpart of ``repro.launch.multihost``).

One process owns one rank, and one rank owns one device:

  * :func:`initialize` joins the process group, with the coordinator
    address, process count and process id from explicit arguments or
    the ``REPRO_COORDINATOR`` / ``REPRO_NUM_PROCESSES`` /
    ``REPRO_PROCESS_ID`` environment (the JAX launcher's variables), as
    ``init_process_group(init_method="tcp://host:port")``.  The backend
    is ``nccl`` for a CUDA rank, which takes card ``process_id %
    device_count``, and ``gloo`` when the CPU is asked for; there is no
    fallback from one to the other.  The group has a finite timeout, so
    a lost peer fails the run instead of hanging it.  One process is a
    no-op.
  * :func:`place_federation` — every process loads the same host-side
    federation (the synthetic twins are deterministic) and puts on its
    device only its own rows of the training windows; the window counts
    and the validation set are replicated.
  * :func:`fetch_replicated` — a replicated tree (the population
    params) as host numpy, on every process; the checkpoint's single
    writer guards it with :func:`is_primary`.
  * :func:`barrier` and :func:`shutdown`.
"""
from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import process_row_slice  # noqa: F401  (re-exported)
from repro_torch.device import resolve_device

ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

# how long a collective waits for a peer before the run fails
DEFAULT_TIMEOUT = timedelta(seconds=300)


def _env(name: str, cast=str):
    v = os.environ.get(name)
    return cast(v) if v not in (None, "") else None


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, device=None,
               timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join (or skip) the process group.

    Arguments default to the ``REPRO_*`` environment.  Returns True when
    a multi-process group was formed (or already was), False for the
    one-process no-op (``num_processes`` unset, 0 or 1).  ``device``
    (default CUDA) picks the backend: ``nccl`` on CUDA, after
    ``torch.cuda.set_device(process_id % device_count)``; ``gloo`` on
    the CPU."""
    coordinator = coordinator or _env(ENV_COORDINATOR)
    num_processes = num_processes if num_processes is not None else _env(ENV_NUM_PROCESSES, int)
    process_id = process_id if process_id is not None else _env(ENV_PROCESS_ID, int)
    if not num_processes or num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if coordinator is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator + process_id "
                         f"(got coordinator={coordinator!r}, process_id={process_id!r})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=timeout)
    return True


def is_primary() -> bool:
    """True on the process that owns the side effects (the report, the
    checkpoint): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Sync every process; a no-op on one."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def place_federation(mesh, x, y, counts, val_data=None, *, device):
    """This rank's rows of the padded training windows ``x`` (N, M, L)
    and ``y`` (N, M) on ``device``, with the (N,) window counts and the
    validation set replicated: ``(x, y, counts, val_data)`` as tensors."""
    rows = process_row_slice(mesh, np.shape(counts))

    def put(a, dtype, sel=slice(None)):
        return torch.as_tensor(np.asarray(a)[sel].astype(dtype)).to(device)
    if val_data is not None:
        val_data = tuple(put(v, np.float32) for v in val_data)
    return (put(x, np.float32, rows), put(y, np.float32, rows), put(counts, np.int64),
            val_data)


def fetch_replicated(tree: dict) -> dict:
    """Host numpy copies of a dict of tensors every rank holds whole (the
    population params); every process gets the value."""
    return {k: v.detach().cpu().numpy() for k, v in tree.items()}
