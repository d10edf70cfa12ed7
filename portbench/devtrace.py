"""Reading a ``torch.profiler`` trace of the window (CPU and CUDA
activity): device busy time, its split by the trainer's spans, each
kernel's device time, and the device's idle gaps by what the host was
doing.

The span attribution is a frozen copy of ``chip_smoke.py``'s
``span_breakdown``: each device kernel or copy goes to the trainer span
(``record_function`` in ``core/gluadfl.py``) whose range on the device
timeline holds its start, "other" where none does.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

# the trainer's record_function spans, in the order of a round
SPANS = ("round.draws", "round.mixing_operator", "round.gossip", "round.local_step",
         "round.mask", "round.eval", "chunk.sync")
# the benchmark's own span around the traced window
WINDOW = "portbench.window"
ANNOTATIONS = SPANS + ("round.secure_mask", WINDOW)
TOP = 10  # entries of each breakdown list


@dataclass
class Trace:
    """What the readers take from one profile."""

    busy_s: float                      # union of device work intervals
    span_ms: dict[str, float]          # device ms of the work starting in each span
    kernel_ms: dict[str, float]        # device ms by kernel or copy name
    kernel_calls: dict[str, int]
    idle_by_host: dict[str, float] = field(default_factory=dict)  # idle s by host span

    def kernels(self, match) -> tuple[float, int]:
        """Device ms and launches of the kernels whose name ``match``
        accepts."""
        names = [k for k in self.kernel_ms if match(k)]
        return sum(self.kernel_ms[k] for k in names), sum(self.kernel_calls[k] for k in names)

    def breakdown(self) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing, in seconds, at most ``TOP`` each."""
        ops = sorted(self.kernel_ms.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[name[:200], ms / 1e3] for name, ms in ops],
                "idle_gaps": [[name, s] for name, s in gaps]}


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def read(prof) -> Trace:
    """Reduce a finished profile to a :class:`Trace` (times in the
    profiler's microseconds become ms and s)."""
    events = list(prof.events())
    device = [e for e in events if _is_device(e)]
    # the spans' ranges on the device timeline; one stream runs them, so they do not overlap
    ranges = sorted((e.time_range.start, e.time_range.end, e.name) for e in device
                    if e.name in SPANS)
    starts = [a for a, _, _ in ranges]
    work = [e for e in device
            if e.name not in ANNOTATIONS and not getattr(e, "is_user_annotation", False)]
    span_ms = dict.fromkeys(SPANS + ("other",), 0.0)
    kernel_ms: dict[str, float] = {}
    calls: dict[str, int] = {}
    for e in work:
        lo, hi = e.time_range.start, e.time_range.end
        i = bisect.bisect_right(starts, lo) - 1
        owner = ranges[i][2] if i >= 0 and lo < ranges[i][1] else "other"
        span_ms[owner] += (hi - lo) / 1e3
        kernel_ms[e.name] = kernel_ms.get(e.name, 0.0) + (hi - lo) / 1e3
        calls[e.name] = calls.get(e.name, 0) + 1
    busy = _union([(e.time_range.start, e.time_range.end) for e in work])
    trace = Trace(sum(hi - lo for lo, hi in busy) / 1e6, span_ms, kernel_ms, calls)
    window = [e for e in events if not _is_device(e) and e.name == WINDOW]
    if window:
        trace.idle_by_host = _idle_by_host(events, busy, window[0].time_range)
    return trace


def _idle_by_host(events, busy, window) -> dict[str, float]:
    """The device's idle seconds inside the window, each gap under the
    trainer span the host was in when it began ("outside the spans"
    where none; the trainer's spans do not nest)."""
    host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if not _is_device(e) and e.name in SPANS)
    starts = [a for a, _, _ in host]
    edges = [window.start] + [t for lo, hi in busy for t in (lo, hi)] + [window.end]
    out: dict[str, float] = {}
    for lo, hi in zip(edges[0::2], edges[1::2]):
        lo, hi = max(lo, window.start), min(hi, window.end)
        if hi <= lo:
            continue
        i = bisect.bisect_right(starts, lo) - 1
        name = host[i][2] if i >= 0 and host[i][1] > lo else "outside the spans"
        out[name] = out.get(name, 0.0) + (hi - lo) / 1e6
    return out
