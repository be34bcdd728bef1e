"""Thread-safe counters and nanosecond timers: the part of
``repro.core.metrics.Metrics`` the serving path uses."""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager


class Metrics:
    """Thread-safe counters + nanosecond timers, cheap enough for hot paths."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.ns = defaultdict(int)        # category -> total ns
        self.count = defaultdict(int)     # category/event -> occurrences

    @contextmanager
    def timer(self, category: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.add_ns(category, time.perf_counter_ns() - t0)

    def add_ns(self, category: str, ns: int) -> None:
        with self._lock:
            self.ns[category] += ns
            self.count[category] += 1

    def bump(self, event: str, n: int = 1) -> None:
        with self._lock:
            self.count[event] += n

    def snapshot(self) -> dict:
        with self._lock:
            return {"ns": dict(self.ns), "count": dict(self.count)}

    def reset(self) -> None:
        with self._lock:
            self.ns.clear()
            self.count.clear()
