"""The port's spans: every traced region of ``repro_torch`` opens
:func:`span`, and nothing else in the package opens a profiler range.

``span(name)`` always opens ``torch.profiler.record_function(name)``, so
a profile names the region on the host and on the device timeline, on
the profiler's own clock.  While a ``torch.profiler`` session records,
and only then, the span is *armed* and the tracer also keeps:

  * its host time (``time.perf_counter_ns``) and its self host time, the
    part that its child spans do not cover;
  * its device time on CUDA: the elapsed time on the current stream
    between two timing events, one at each end (idle gaps inside the
    span included);
  * the synchronizing CUDA calls made inside it, from PyTorch's sync
    debug mode (``torch.cuda.set_sync_debug_mode("warn")``), each
    counted to the innermost open span.  The mode is on only while an
    armed span is open; its reports are caught and never printed;
  * its parent, the span open around it.

So any profiled run, the benchmark's traced window among them, gets
the program's own numbers with no option set.  The tracer keeps
aggregates by span name (:class:`SpanStats`).  A span's device events
are read once they have completed, when an outermost span ends: after
a chunk's host sync they all have, so no synchronize is added, and
events read are released.  :func:`snapshot` reads what is left (its
caller has synchronized) and returns the aggregates; :func:`reset`
clears them.  The profiler's chrome trace stays the timeline: there is
no other exporter.

Disarmed, a span costs one flag check on top of ``record_function``
(PERF.md gives the cost armed and disarmed on the card).  The tracer
follows the thread that drives the port, as the port opens every span
on it.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field, replace

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

# the start of the report the sync debug mode's "warn" gives each synchronizing call
SYNC_REPORT = "called a synchronizing CUDA operation"


@dataclass
class SpanStats:
    """One span name's aggregates over its armed calls (ms)."""

    calls: int = 0
    host_ms: float = 0.0
    self_host_ms: float = 0.0
    device_ms: float | None = None   # None where no call ran with CUDA initialized
    syncs: int = 0                   # synchronizing calls counted to this span itself
    parents: dict = field(default_factory=dict)  # enclosing span's name (None: none) -> calls


class _Open:
    """An armed span while it is open."""

    __slots__ = ("name", "parent", "t0", "child_ns", "syncs", "start")

    def __init__(self, name: str, parent: str | None, start):
        self.name, self.parent, self.start = name, parent, start
        self.child_ns = self.syncs = 0
        self.t0 = time.perf_counter_ns()


class Tracer:
    """The aggregates of the armed spans, the open ones and the device
    events not read yet."""

    def __init__(self):
        self._stats: dict[str, SpanStats] = {}
        self._stack: list[_Open] = []
        self._pending: list[tuple[str, torch.cuda.Event, torch.cuda.Event]] = []
        self._catch = None            # the outermost span's warnings context on CUDA
        self._shown = None            # warnings.showwarning outside it
        self._mode = 0                # the sync debug mode outside it

    def enter(self, name: str) -> _Open:
        stack = self._stack
        cuda = torch.cuda.is_initialized()
        if not stack and cuda:
            self._catch_syncs()
        start = None
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        rec = _Open(name, stack[-1].name if stack else None, start)
        stack.append(rec)
        return rec

    def exit(self, rec: _Open) -> None:
        if rec.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._pending.append((rec.name, rec.start, end))
        ns = time.perf_counter_ns() - rec.t0
        stack = self._stack
        stack.pop()
        stats = self._stats.get(rec.name)
        if stats is None:
            stats = self._stats[rec.name] = SpanStats()
        stats.calls += 1
        stats.host_ms += ns / 1e6
        stats.self_host_ms += (ns - rec.child_ns) / 1e6
        stats.syncs += rec.syncs
        stats.parents[rec.parent] = stats.parents.get(rec.parent, 0) + 1
        if stack:
            stack[-1].child_ns += ns
        else:
            if self._catch is not None:
                self._release_syncs()
            self._read_events(wait=False)

    def _catch_syncs(self) -> None:
        """Turn the sync debug mode's reports on and route them to
        :meth:`_on_warning` until the outermost span ends."""
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_REPORT)
        self._shown = warnings.showwarning
        warnings.showwarning = self._on_warning
        self._mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")

    def _release_syncs(self) -> None:
        torch.cuda.set_sync_debug_mode(self._mode)
        catch, self._catch, self._shown = self._catch, None, None
        catch.__exit__(None, None, None)

    def _on_warning(self, message, category, filename, lineno, file=None, line=None):
        if str(message).startswith(SYNC_REPORT) and self._stack:
            self._stack[-1].syncs += 1
        else:
            self._shown(message, category, filename, lineno, file, line)

    def _read_events(self, wait: bool) -> None:
        """Add the device time of each closed span whose end event has
        completed, in the order they closed (all of them with ``wait``,
        after the caller's synchronize), and release their events."""
        done = 0
        for name, start, end in self._pending:
            if wait:
                end.synchronize()
            elif not end.query():
                break
            stats = self._stats[name]
            stats.device_ms = (stats.device_ms or 0.0) + start.elapsed_time(end)
            done += 1
        del self._pending[:done]

    def snapshot(self) -> dict[str, SpanStats]:
        """The aggregates by span name, every closed span's device time
        read."""
        self._read_events(wait=True)
        return {name: replace(s, parents=dict(s.parents)) for name, s in self._stats.items()}

    def reset(self) -> None:
        self._stats.clear()
        self._pending.clear()


_TRACER = Tracer()
snapshot = _TRACER.snapshot
reset = _TRACER.reset


class _Span:
    __slots__ = ("_name", "_range", "_open")

    def __init__(self, name: str):
        self._name = name
        self._range = record_function(name)
        self._open = None

    def __enter__(self):
        self._range.__enter__()
        if _autograd_profiler._is_profiler_enabled:
            self._open = _TRACER.enter(self._name)
        return self

    def __exit__(self, *exc):
        try:
            if self._open is not None:
                _TRACER.exit(self._open)
                self._open = None
        finally:
            self._range.__exit__(*exc)
        return False


def span(name: str) -> _Span:
    """A context manager: the profiler's range ``name``, and while a
    profiler session records, the tracer's span of that name."""
    return _Span(name)
