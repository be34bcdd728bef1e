"""Caiti's algorithm generalized to arbitrary producer→sink transit.

The checkpoint engine (and any other host-side pipeline) uses this class to
get the paper's two policies without caring about blocks/lbas:

  * **eager eviction**  — every item put into the staging buffer is handed to
    a background pool immediately; ``flush()`` (the fsync analogue) therefore
    finds the buffer nearly empty.
  * **conditional bypass** — when staging RAM is exhausted, ``put`` invokes
    the sink synchronously instead of blocking behind the drain.

The staging capacity is measured in bytes so the engine can bound host-RAM
usage precisely (the 'DRAM cache' of the paper).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

from .metrics import Metrics


class TransitBuffer:
    def __init__(self, sink: Callable[[object], None],
                 capacity_bytes: int = 256 << 20, n_workers: int = 2,
                 eager: bool = True, bypass: bool = True,
                 metrics: Metrics | None = None, admission=None) -> None:
        self.sink = sink
        self.capacity = capacity_bytes
        self.eager = eager
        self.bypass = bypass
        # optional repro_torch.volume.AdmissionPolicy: when the unified policy
        # says the system is over its aggregate watermark, a put bypasses
        # staging even though THIS buffer still has room — the same
        # global conditional-bypass rule the block-level caches follow
        self.admission = admission
        self.metrics = metrics or Metrics()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._staged_bytes = 0
        self._enqueued = 0
        self._completed = 0
        self._errors: list[BaseException] = []
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._stop = False
        self._workers = [threading.Thread(target=self._run, daemon=True,
                                          name=f"transit-{i}")
                         for i in range(n_workers)]
        for w in self._workers:
            w.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            payload, nbytes = item
            try:
                self.sink(payload)
            except BaseException as e:  # surfaced at flush()
                with self._lock:
                    self._errors.append(e)
            with self._cond:
                self._staged_bytes -= nbytes
                self._completed += 1
                self._cond.notify_all()

    def put(self, payload, nbytes: int) -> str:
        """Stage one item. Returns 'staged' or 'bypass'."""
        globally_full = (self.bypass and self.admission is not None
                         and self.admission.should_bypass_write())
        with self._lock:
            full = globally_full \
                or self._staged_bytes + nbytes > self.capacity
            if not full:
                self._staged_bytes += nbytes
                self._enqueued += 1
        if full:
            if self.bypass:
                # conditional bypass: sink synchronously, skip staging
                with self.metrics.timer("conditional_bypass"):
                    self.sink(payload)
                self.metrics.bump("bypass_writes")
                return "bypass"
            # no-bypass: block until the drain makes room (staging behaviour)
            with self._cond:
                while self._staged_bytes + nbytes > self.capacity:
                    self._cond.wait(timeout=0.5)
                self._staged_bytes += nbytes
                self._enqueued += 1
        if self.eager:
            self._q.put((payload, nbytes))          # eager eviction
        else:
            with self._lock:
                self._lazy = getattr(self, "_lazy", [])
                self._lazy.append((payload, nbytes))
        return "staged"

    def flush(self) -> None:
        """fsync analogue: wait until everything staged so far is sunk."""
        with self.metrics.timer("cache_flush"):
            if not self.eager:
                with self._lock:
                    lazy = getattr(self, "_lazy", [])
                    self._lazy = []
                for item in lazy:
                    self._q.put(item)
            with self._cond:
                target = self._enqueued
                while self._completed < target:
                    self._cond.wait(timeout=0.5)
                if self._errors:
                    err = self._errors[0]
                    self._errors.clear()
                    raise err

    def staged_bytes(self) -> int:
        with self._lock:
            return self._staged_bytes

    def close(self) -> None:
        self.flush()
        for _ in self._workers:
            self._q.put(None)
        for w in self._workers:
            w.join(timeout=2.0)
