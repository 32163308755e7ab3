"""Host spans of the harness, and the reduction of a ``torch.profiler``
trace of the device to busy time, time by operation and idle gaps named by
the span the host was in.

The trace records CUDA activity only: recording every host operation as
well would slow the eager train step by about a third and show that as
idle device time.  The harness's spans are named from their wall-clock
intervals, which are on the profiler's clock (``time.time_ns``)."""
from __future__ import annotations

import contextlib
import time

from benchkit import stats


class Spans:
    """Durations by name on the host clock, and each span's wall-clock
    interval [start_ns, end_ns)."""

    def __init__(self):
        self.durations: dict = {}
        self.intervals: list = []

    @contextlib.contextmanager
    def record(self, name: str):
        t0, w0 = time.perf_counter(), time.time_ns()
        yield
        self.intervals.append((w0, time.time_ns(), name))
        self.durations.setdefault(name, []).append(time.perf_counter() - t0)


def _profile():
    import torch
    from torch.profiler import ProfilerActivity
    return torch.profiler.profile(activities=[ProfilerActivity.CUDA])


@contextlib.contextmanager
def warm_profiler():
    """A profile that is thrown away: a process's first profile
    initialises the profiler's device side, which would otherwise land in
    the traced window."""
    with _profile():
        yield


class Tracer:
    """A trace of the device over the first part of a window, from its
    creation until ``stop(steps)``; ``summary(spans)`` reduces it once the
    window has closed."""

    def __init__(self, device):
        from benchkit.core import sync
        self.device = device
        self.prof = _profile()
        self.prof.start()
        sync(device)
        self.lo = time.time_ns()
        self.steps = None
        self.stopped = None

    def stop(self, steps: int):
        if self.steps is not None:
            return
        from benchkit.core import sync
        sync(self.device)
        self.hi = time.time_ns()
        self.prof.stop()
        self.steps, self.stopped = steps, time.perf_counter()

    @property
    def tracing(self) -> bool:
        return self.steps is None

    def summary(self, spans: Spans) -> dict:
        from torch.autograd import DeviceType
        start = self.prof.profiler.kineto_results.trace_start_ns()
        dev = [(e.time_range.start, e.time_range.end, e.name)
               for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]

        def us(ns):
            return (ns - start) * 1e-3
        return summarize(dev, us(self.lo), us(self.hi),
                         [(us(s), us(t), n) for s, t, n in spans.intervals
                          if t > self.lo and s < self.hi])


def summarize(dev, lo: float, hi: float, spans) -> dict:
    """From the device's operations [(start, end, name)] in microseconds:
    ``busy_s`` (the union of device activity within [lo, hi)),
    ``window_s``, ``ops`` {device op name: seconds} and ``idle`` {host
    span: idle device seconds}, each piece of a gap named by the innermost
    host span of ``spans`` [(start, end, name)] that holds it.  Empty
    where no device operation falls in the window."""
    clipped = [(max(s, lo), min(t, hi), n) for s, t, n in dev
               if t > lo and s < hi]
    if not clipped:
        return {}
    ops: dict = {}
    for s, t, n in clipped:
        ops[n] = ops.get(n, 0.0) + (t - s) * 1e-6
    busy = stats.union_length([(s, t) for s, t, _ in clipped]) * 1e-6
    inner = sorted(spans, key=lambda a: a[1] - a[0])
    idle: dict = {}
    for gs, ge in stats.gaps([(s, t) for s, t, _ in clipped], lo, hi):
        # cut the gap where a host span starts or ends inside it; each piece
        # goes to the innermost span that holds it
        cuts = sorted({gs, ge, *(x for s, t, _ in inner for x in (s, t)
                                 if gs < x < ge)})
        for a, z in zip(cuts, cuts[1:]):
            mid = (a + z) / 2
            name = next((n for s, t, n in inner if s <= mid < t),
                        "between spans")
            idle[name] = idle.get(name, 0.0) + (z - a) * 1e-6
    return {"busy_s": busy, "window_s": (hi - lo) * 1e-6, "ops": ops,
            "idle": idle}


def breakdown(summary: dict, n: int = 10) -> dict:
    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:n]]
    return {"device_ops": top(summary.get("ops", {})),
            "idle_gaps": top(summary.get("idle", {}))}


def device_seconds(summary: dict, *needles: str) -> float:
    """Device seconds of the operations whose name holds any needle."""
    return sum(v for k, v in summary.get("ops", {}).items()
               if any(x in k for x in needles))
