"""Spans of the serving path, riding on a :class:`Metrics`.

A span names one call or one layer's part of it, such as
``lm.decode_step`` or ``kvcache.table``.  Off by default, a span is one
shared no-op context: no clock is read and nothing recorded.  Between
:meth:`Trace.start` and :meth:`Trace.stop` each span records its name,
``t0`` and ``t1`` on ``time.perf_counter_ns``, its parent's index (a
per-thread stack, so a worker thread's spans are roots of their own), the
request's ``sid`` and a few counts, in a list of at most ``SPAN_CAP``
(the metrics' ``spans_dropped`` counts the rest), and enters
``torch.profiler.record_function(name)``, so that the span also lands in
a profiler's trace on the profiler's clock.

``core/metrics.py`` is the reference's text, so the spans are not its
methods: :func:`trace_of` keeps one :class:`Trace` on a ``Metrics``
object, and whoever shares that object (an engine, its model and its
cache) shares its spans and counters alike.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import NamedTuple

from .metrics import Metrics

#: spans kept while tracing; past it ``count["spans_dropped"]`` counts them
SPAN_CAP = 1 << 20

_OFF = nullcontext()       # every span while tracing is off


class Span(NamedTuple):
    """One recorded span; ``parent`` is the index of the span it ran in
    (None for a thread's root), ``t1`` None while it is still open."""
    name: str
    t0: int
    t1: int | None
    parent: int | None
    sid: int | None
    counts: dict


class _On:
    """A span while tracing is on."""
    __slots__ = ("trace", "name", "sid", "counts", "rec", "rf")

    def __init__(self, trace: "Trace", name: str, sid, counts: dict) -> None:
        self.trace, self.name, self.sid, self.counts = trace, name, sid, counts

    def __enter__(self):
        tr = self.trace
        stack = tr._stack()
        self.rec = rec = [self.name, 0, None, stack[-1] if stack else None,
                          self.sid, self.counts]
        with tr._lock:
            idx = len(tr._spans)
            if idx < SPAN_CAP:
                tr._spans.append(rec)
            else:
                idx = None
        if idx is None:
            tr.metrics.bump("spans_dropped")
        stack.append(idx)
        self.rf = tr._record_function(self.name)
        self.rf.__enter__()
        rec[1] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.rec[2] = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        self.trace._stack().pop()
        return False


class Trace:
    """The spans of one :class:`Metrics` (see the module's docstring)."""

    def __init__(self, metrics: Metrics) -> None:
        self.metrics = metrics
        self.tracing = False
        self._lock = threading.Lock()
        self._spans: list[list] = []
        self._local = threading.local()
        self._record_function = None

    def span(self, name: str, sid: int | None = None, **counts):
        """A context around one call (or one layer of it); records only
        while tracing.  ``counts`` are a few small ints, such as
        ``pages=`` or ``n=``."""
        if not self.tracing:
            return _OFF
        return _On(self, name, sid, counts)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def start(self) -> None:
        from torch.profiler import record_function
        self._record_function = record_function
        self.tracing = True

    def stop(self) -> None:
        self.tracing = False

    def spans(self) -> list[Span]:
        """The recorded spans, in the order they were entered."""
        with self._lock:
            return [Span(*rec) for rec in self._spans]

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()


def trace_of(metrics: Metrics) -> Trace:
    """The :class:`Trace` kept on ``metrics``, made at its first use."""
    trace = getattr(metrics, "trace", None)
    if trace is None:
        trace = metrics.trace = Trace(metrics)
    return trace
