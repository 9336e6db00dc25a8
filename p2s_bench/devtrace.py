"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
the whole measured window, reduced to the device's busy time (the union of
its operations' intervals), the operations that took most time, and the
idle gaps labelled by the harness span that was open on the host.

The profiler's clock is tied to the host's by a marker: after a
synchronize, the host notes its time and launches ``torch.cuda._sleep``,
whose kernel then starts at once on the idle card.
"""

from __future__ import annotations

import time

MARKER = "spin_kernel"
TOP = 10


class DeviceTrace:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.mark_host = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.torch.cuda.synchronize()
        self.mark_host = time.perf_counter()
        self.torch.cuda._sleep(1000)

    def stop(self) -> list[tuple[str, float, float]]:
        """(name, start, end) of every device operation, in seconds on the
        host's ``perf_counter`` clock, the marker left out."""
        self.torch.cuda.synchronize()
        self.prof.stop()
        events = _device_events(self.torch, self.prof)
        marks = [e for e in events if MARKER in e[0]]
        if marks:
            offset = self.mark_host - min(e[1] for e in marks)
        elif events:  # no marker: the first operation starts the window
            offset = self.mark_host - min(e[1] for e in events)
        else:
            offset = 0.0
        return sorted((n, t0 + offset, t1 + offset) for n, t0, t1 in events
                      if MARKER not in n)


def _device_events(torch, prof) -> list[tuple[str, float, float]]:
    from torch.autograd import DeviceType

    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), e.start_ns() / 1e9,
                 (e.start_ns() + e.duration_ns()) / 1e9)
                for e in raw if e.device_type() == DeviceType.CUDA]
    except AttributeError:
        return [(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                for e in prof.events() if e.device_type == DeviceType.CUDA]


def busy_intervals(events, t0: float, t1: float) -> list[tuple[float, float]]:
    """The union of the operations' intervals, clipped to [t0, t1]."""
    merged = []
    for _, a, b in sorted(events, key=lambda e: e[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def reduce(events, t0: float, t1: float, spans) -> dict:
    """busy_s, the device operations that took most time, and the idle
    seconds by the span open on the host (``other`` where none was)."""
    busy = busy_intervals(events, t0, t1)
    by_op: dict[str, float] = {}
    for name, a, b in events:
        by_op[name] = by_op.get(name, 0.0) + (b - a)
    idle: dict[str, float] = {}
    edge = t0
    for a, b in busy + [(t1, t1)]:
        if a > edge:
            label = spans.at(0.5 * (edge + a)) or "other"
            idle[label] = idle.get(label, 0.0) + (a - edge)
        edge = max(edge, b)

    def top(d):
        return [[k[:120], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return {"busy_s": sum(b - a for a, b in busy),
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(idle)}}


def op_seconds(events, *substrings: str) -> float:
    """Device seconds of the operations whose name holds any of
    ``substrings``."""
    return sum(b - a for n, a, b in events
               if any(s in n for s in substrings))
