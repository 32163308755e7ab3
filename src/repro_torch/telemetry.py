"""Spans and counters inside the port, off unless a caller turns them on.

    telemetry.enable()
    with telemetry.span("engine.prefill_chunk", key=slot):
        ...
    telemetry.count("offload.carry_waits", 1)
    spans, counters = telemetry.drain()
    telemetry.disable()

A span is ``Span(name, start_ns, end_ns, parent, thread, key)``: its
interval on ``time.time_ns``'s clock (the clock ``torch.profiler`` puts a
trace on, so a span taken inside a caller's ``time.time_ns`` interval lies
inside it), the name of the innermost span open on the same thread when it
began (None at the top), the thread it ran on (autograd runs a CUDA
backward on a device thread of its own, so a span inside a block's
backward has its own thread and no parent there), and an optional integer
that ties one request's spans together (a slot).  Names carry their
layer's prefix: ``plan.``, ``train.``, ``offload.``, ``engine.``.

Off, ``span`` reads one module flag and returns one shared no-op context:
no allocation, no clock.  ``count`` and ``elapsed_ms`` return at once.
Spans go at layer boundaries only, never per leaf, layer or page.
"""
from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    thread: int
    key: Optional[int]


class _Off:
    """The context ``span`` returns while the recorder is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()

_on = False
_lock = threading.Lock()
_spans: list = []
_counters: dict = {}
_pending: list = []          # (counter, start event, end event)
_open = threading.local()    # .stack: names of the thread's open spans


class _Span:
    __slots__ = ("name", "key", "parent", "start")

    def __init__(self, name: str, key: Optional[int]):
        self.name, self.key = name, key

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.stack.pop()
        with _lock:
            _spans.append(Span(self.name, self.start, end, self.parent,
                               threading.get_ident(), self.key))
        return False


def span(name: str, key: Optional[int] = None):
    """A context that records ``name`` over its body while the recorder is
    on; the shared no-op ``OFF`` while it is off."""
    if not _on:
        return OFF
    return _Span(name, key)


def enabled() -> bool:
    return _on


def count(name: str, n=1):
    """Add ``n`` to counter ``name`` while the recorder is on."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def elapsed_ms(name: str, start, end):
    """Add the device time between two recorded CUDA events (``enable_timing``
    on) to counter ``name`` in milliseconds, once ``drain`` resolves it; the
    caller records the events only while the recorder is on."""
    if not _on:
        return
    with _lock:
        _pending.append((name, start, end))


def enable():
    global _on
    _on = True


def disable():
    global _on
    _on = False


def drain() -> tuple:
    """(the spans recorded, ordered by start; the counters), both cleared.
    Pending device timings wait for their end events and land in the
    counters first."""
    with _lock:
        pending, spans, counters = list(_pending), list(_spans), \
            dict(_counters)
        _pending.clear()
        _spans.clear()
        _counters.clear()
    for name, start, end in pending:
        end.synchronize()
        counters[name] = counters.get(name, 0.0) + start.elapsed_time(end)
    return sorted(spans, key=lambda s: s.start_ns), counters
