"""Request micro-batching for the BG-forecast service (a copy of
``repro.serve.batcher``; the port keeps its own so that it never imports
the JAX package): a host-side queue that turns an asynchronous request
stream into padded-bucket batches for ``GlucoseServable.forecast``.

Policy (saxml-style):

  * **pad-to-bucket** — a formed batch is sized to the smallest
    configured bucket that fits it (:func:`bucket_for`); the servable
    pads the remainder, so the kernel only ever sees ``len(buckets)``
    batch shapes;
  * **formation** — a batch forms as soon as the queue can fill the
    LARGEST bucket (throughput), or when the oldest queued request has
    waited ``flush_timeout`` seconds (latency floor for trickle
    traffic);
  * **admission** — at most ``max_live_batches`` formed-but-unfinished
    batches exist at once; :meth:`MicroBatcher.ready` returns ``None``
    while the service is saturated, bounding queue->device inflight
    memory;
  * **failure** — a batch whose execution raised must be handed back via
    :meth:`MicroBatcher.fail` (the ``except`` twin of
    :meth:`MicroBatcher.complete`): it frees the admission slot and
    either requeues the requests at the FRONT of the queue (transient
    errors) or drops them with accounting.  Without it an exception
    between formation and completion leaks the slot forever and
    admission permanently saturates;
  * **accounting** — every request is stamped at submit / batch-start /
    completion, and :meth:`MicroBatcher.stats` reduces the finished
    stream to p50/p99 latency, mean queue wait, and throughput (plus
    failed/dropped counts; non-finite stamps are excluded so a stray
    never-completed request cannot NaN the percentiles).

Everything here is plain Python on the host — no torch — and the clock is
injectable (``clock=``), so the whole policy is unit-testable with a
fake clock (``tests/test_torch_serve.py``).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket >= ``n``, or the largest bucket when ``n``
    overflows every one (the caller then splits the batch).  ``buckets``
    must be sorted ascending (the :class:`MicroBatcher`/servable
    constructors normalize this)."""
    if n < 1:
        raise ValueError(f"batch of {n} requests has no bucket")
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclass
class Request:
    """One CGM-window -> BG-forecast request.

    ``patient`` names a row of the servable's param store (0 is always
    the population model — the brand-new-patient default; personalized
    patients get their own row).  Timestamps are stamped by the batcher:
    ``t_submit`` at :meth:`MicroBatcher.submit`, ``t_start`` when its
    batch forms, ``t_done`` at :meth:`MicroBatcher.complete`.
    """

    rid: int
    patient: int
    window: np.ndarray  # (L,) normalized CGM history
    t_submit: float = field(default=float("nan"))
    t_start: float = field(default=float("nan"))
    t_done: float = field(default=float("nan"))

    @property
    def latency(self) -> float:
        """Submit-to-completion seconds (queue wait + execution)."""
        return self.t_done - self.t_submit

    @property
    def queue_wait(self) -> float:
        """Submit-to-batch-formation seconds."""
        return self.t_start - self.t_submit


class MicroBatcher:
    """The admission/formation policy around a ``deque`` of requests.

    The caller drives it:  ``submit()`` incoming requests, poll
    ``ready()`` for the next formed batch (``None`` = keep waiting),
    run the batch, then ``complete()`` it so its admission slot frees
    and its requests' latencies are recorded.  ``flush()`` force-forms
    the tail at shutdown/drain time regardless of the timeout (but
    still honoring admission).
    """

    def __init__(
        self,
        buckets: tuple[int, ...] = (1, 4, 16, 64),
        *,
        max_live_batches: int = 4,
        flush_timeout: float = 0.005,
        clock: Callable[[], float] = time.monotonic,
    ):
        buckets = tuple(sorted({int(b) for b in buckets}))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"need >= 1 positive bucket size, got {buckets!r}")
        if max_live_batches < 1:
            raise ValueError("max_live_batches must be >= 1")
        self.buckets = buckets
        self.max_live_batches = max_live_batches
        self.flush_timeout = flush_timeout
        self._clock = clock
        self._queue: deque[Request] = deque()
        self._live = 0
        self._finished: list[Request] = []
        self._failed_batches = 0
        self._dropped = 0

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        """Enqueue a request (stamps its arrival time)."""
        req.t_submit = self._clock()
        self._queue.append(req)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def live_batches(self) -> int:
        return self._live

    # --------------------------------------------------------- formation
    def _form(self, k: int) -> list[Request]:
        now = self._clock()
        batch = [self._queue.popleft() for _ in range(k)]
        for r in batch:
            r.t_start = now
        self._live += 1
        return batch

    def ready(self) -> Optional[list[Request]]:
        """The next batch to run, or ``None`` (queue empty, timeout not
        reached, or admission saturated).  A full largest bucket forms
        immediately; otherwise the queue waits out ``flush_timeout``
        from the OLDEST request's submit time, then ships everything
        queued (capped at the largest bucket)."""
        if self._live >= self.max_live_batches or not self._queue:
            return None
        cap = self.buckets[-1]
        if len(self._queue) >= cap:
            return self._form(cap)
        if self._clock() - self._queue[0].t_submit >= self.flush_timeout:
            return self._form(len(self._queue))
        return None

    def flush(self) -> Optional[list[Request]]:
        """Force-form the queued tail (drain path) — admission still
        applies, so call :meth:`complete` between flushes."""
        if self._live >= self.max_live_batches or not self._queue:
            return None
        return self._form(min(len(self._queue), self.buckets[-1]))

    # -------------------------------------------------------- accounting
    def complete(self, batch: list[Request]) -> None:
        """Record a run batch: frees its admission slot and stamps +
        collects per-request completion times."""
        now = self._clock()
        self._live -= 1
        assert self._live >= 0, "complete() without a matching ready()/flush()"
        for r in batch:
            r.t_done = now
        self._finished.extend(batch)

    def fail(self, batch: list[Request], *, requeue: bool = False) -> None:
        """Hand back a batch whose execution RAISED — the ``except``-path
        twin of :meth:`complete`.  Frees the admission slot (without it
        the slot leaks and ``ready()`` saturates forever), then either
        requeues the requests at the front of the queue in their original
        order (``requeue=True`` — transient failures; their submit stamps
        survive, so the flush timeout still honors true arrival time and
        an eventual completion reports true end-to-end latency) or drops
        them with accounting (``requeue=False`` — the default: a batch
        that crashed the model is usually poisoned input)."""
        self._live -= 1
        assert self._live >= 0, "fail() without a matching ready()/flush()"
        self._failed_batches += 1
        if requeue:
            for r in batch:
                r.t_start = float("nan")  # re-stamped when it re-forms
            self._queue.extendleft(reversed(batch))
        else:
            self._dropped += len(batch)

    def stats(self) -> dict:
        """Latency/throughput summary of every completed request:
        p50/p99 latency (ms), mean queue wait (ms), requests completed,
        forecasts/sec over the completed span, and failure accounting
        (``failed_batches``, ``dropped``).  Requests that never ran to
        completion carry NaN stamps — they are excluded from every
        reduction, so the percentiles stay finite no matter what the
        caller mixed into the stream."""
        base = {"failed_batches": self._failed_batches, "dropped": self._dropped}
        done = [
            r for r in self._finished
            if np.isfinite(r.t_submit) and np.isfinite(r.t_done)
        ]
        if not done:
            return {"completed": 0, **base}
        lat = np.asarray([r.latency for r in done])
        wait = np.asarray([r.queue_wait for r in done])
        wait = wait[np.isfinite(wait)]
        span = max(r.t_done for r in done) - min(r.t_submit for r in done)
        return {
            "completed": len(done),
            "p50_latency_ms": float(np.percentile(lat, 50) * 1e3),
            "p99_latency_ms": float(np.percentile(lat, 99) * 1e3),
            "mean_queue_wait_ms": (
                float(wait.mean() * 1e3) if wait.size else float("nan")
            ),
            "forecasts_per_sec": (
                len(done) / span if span > 0 else float("inf")
            ),
            **base,
        }
