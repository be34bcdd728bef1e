"""Shared background-eviction worker pool for multi-shard volumes.

The paper's Caiti gives *each* device its own eviction threads.  On a
volume composed of N shards that wastes cores: a bursty shard starves
while an idle shard's workers spin.  This pool owns the eviction cores
for the whole volume and drains the shards' write-back queues
congestion-aware: workers prefer the shard with the deepest backlog and
fall back to round-robin among ties, so aggregate PMem bandwidth — the
contended resource — is spent where the staging pressure is.

**Per-socket banks (NUMA placement).**  On a real box each PMem DIMM set
hangs off one socket; an eviction core writing a remote socket's DIMMs
pays the interconnect.  The pool therefore partitions its workers into
``n_sockets`` banks (worker *i* serves socket ``i % n_sockets``) and
participants register with the socket that owns their media
(``register(cache, socket=...)``).  A bank drains its own socket's
queues first and only *steals* cross-socket work when its socket is
idle — locality when busy, work conservation always (a one-slot backlog
on a quiet socket can never wedge that shard's flush).

**Participants.**  Anything exposing the two drain hooks —
``_evict_slot(item)`` / ``_complete_eviction()`` — can register, not
just ``CaitiCache``: the volume's :class:`ReplicaResyncer` drains its
repair queue through the same cores, and ``PagedKVCache`` offloads its
eager page-out DMA here, so background resync and KV-spill traffic are
scheduled (and NUMA-placed) exactly like eviction writebacks.

**Batch draining.**  A worker's pick takes up to ``batch_max`` queued
items from the chosen participant in one go; a participant exposing the
optional ``_evict_slots(items)`` hook gets the whole batch in one call
(one lock acquisition / one fused transit-kernel launch for a burst),
otherwise the worker loops ``_evict_slot`` per item.  Completion
accounting is unchanged: ``_complete_eviction()`` fires once per item.

**Limping-shard steering.**  ``set_limping(participants)`` marks a set
of participants fail-slow (the volume pushes the
:class:`~repro_torch.core.metrics.ShardScorer`'s verdict here): workers drain
every healthy backlog first and touch a limping participant's queue
only when nothing else has work — eviction bandwidth stops feeding the
device that is already 25x slow, but work conservation holds (a limping
shard with the only backlog still drains).  Each deferral is counted
(``steered_picks``) and reported through ``on_steer``.
"""
from __future__ import annotations

import threading
from collections import deque


class SharedEvictionPool:
    """N worker threads draining eviction work for many participants.

    Caches register themselves (``CaitiCache(..., evict_pool=pool)`` does it
    in its constructor); each registered participant gets a private backlog
    deque.  ``submit(cache, item)`` enqueues one work item for background
    processing; a worker later calls the participant's
    ``_evict_slot``/``_complete_eviction`` exactly as a cache's private
    threads would, so per-cache flush accounting is unchanged.
    """

    def __init__(self, n_workers: int = 4, name: str = "vol",
                 n_sockets: int = 1, batch_max: int = 8) -> None:
        assert n_sockets >= 1
        assert batch_max >= 1
        self.n_workers = n_workers
        self.n_sockets = min(n_sockets, max(1, n_workers))
        self.batch_max = batch_max
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # (participant, backlog, socket)
        self._queues: list[tuple[object, deque, int]] = []
        self._rr = 0
        self._picks = 0
        self._stop = False
        self._pending = 0
        self.drained_by_socket = [0] * self.n_sockets
        self.stolen_picks = 0
        self.batched_drains = 0          # picks that drained > 1 item
        self.batched_items = 0           # items drained via batch picks
        # fail-slow steering: participants whose queues drain LAST
        self._limping: set[int] = set()  # participant ids (id() keys)
        self.on_steer = None             # callback per deferred pick
        self.steered_picks = 0
        self._workers = [
            threading.Thread(target=self._run, args=(i % self.n_sockets,),
                             daemon=True, name=f"{name}-evict-{i}")
            for i in range(n_workers)
        ]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------ interface
    def register(self, cache, socket: int = 0) -> None:
        with self._lock:
            self._queues.append((cache, deque(), socket % self.n_sockets))

    def unregister(self, cache) -> list:
        """Remove a participant and return its still-queued (never
        picked) items so the caller can settle its own accounting.
        Items a worker is ALREADY executing are not included — they
        complete through the normal ``_complete_eviction`` path."""
        with self._lock:
            for i, (c, q, _s) in enumerate(self._queues):
                if c is cache:
                    del self._queues[i]
                    self._pending -= len(q)
                    return list(q)
        return []

    def assign_socket(self, cache, socket: int) -> None:
        """Re-pin a registered participant to the socket owning its media
        (the volume calls this after building its shards — ``CaitiCache``
        registers itself before the volume knows the shard layout)."""
        with self._lock:
            for i, (c, q, _s) in enumerate(self._queues):
                if c is cache:
                    self._queues[i] = (c, q, socket % self.n_sockets)
                    return
        raise ValueError("cache not registered with this pool")

    def submit(self, cache, slot) -> None:
        with self._cond:
            for c, q, _s in self._queues:
                if c is cache:
                    q.append(slot)
                    self._pending += 1
                    self._cond.notify_all()
                    return
        raise ValueError("cache not registered with this pool")

    def backlog(self) -> int:
        """Total slots queued across all shards (not yet picked up)."""
        with self._lock:
            return self._pending

    def set_limping(self, participants, on_steer=None) -> None:
        """Mark ``participants`` (an iterable of registered caches) as
        fail-slow: their backlogs drain only when no healthy queue has
        work.  Idempotent — the volume's tail-state refresh calls this
        with the scorer's current verdict every pass."""
        with self._lock:
            self._limping = {id(p) for p in participants}
            if on_steer is not None:
                self.on_steer = on_steer

    # ------------------------------------------------------------- workers
    def _pick(self, socket: int):
        """Congestion-aware, starvation-free pick: picks alternate between
        the deepest backlog and plain round-robin over non-empty queues —
        a strictly-deepest rule would let a shard with one queued slot
        wait forever behind busier shards, wedging that shard's flush.
        Home-socket queues are tried first; an idle bank steals.
        Limping participants (``set_limping``) are deferred: their
        queues are eligible only when no healthy queue has work."""
        n = len(self._queues)
        self._picks += 1
        limping = self._limping
        for local_only in (True, False):
            best = None
            best_depth = 0
            deferred = False                        # skipped limping work
            for avoid in ((True, False) if limping else (False,)):
                deferred = False
                for off in range(n):
                    i = (self._rr + off) % n
                    c, q, s = self._queues[i]
                    if local_only and s != socket:
                        continue
                    if avoid and id(c) in limping:
                        if q:
                            deferred = True
                        continue
                    depth = len(q)
                    if self._picks % 2 and depth > 0:   # RR: first non-empty
                        best, best_depth = i, depth
                        break
                    if depth > best_depth:          # congestion turn: deepest
                        best, best_depth = i, depth
                if best is not None:
                    break                           # healthy work found
            if best is not None:
                if deferred:
                    # a limping backlog was passed over for healthy work
                    self.steered_picks += 1
                    if self.on_steer is not None:
                        self.on_steer()
                self._rr = (best + 1) % n
                cache, q, s = self._queues[best]
                # batch drain: one pick takes up to batch_max items from
                # the SAME participant's backlog — one wakeup (and, for
                # participants with the ``_evict_slots`` hook, one lock
                # acquisition / fused DMA) amortized over the burst
                batch = [q.popleft()]
                while q and len(batch) < self.batch_max:
                    batch.append(q.popleft())
                self._pending -= len(batch)
                self.drained_by_socket[socket] += len(batch)
                if not local_only:
                    self.stolen_picks += 1
                if len(batch) > 1:
                    self.batched_drains += 1
                    self.batched_items += len(batch)
                return cache, batch
            if local_only and self.n_sockets == 1:
                break                               # nothing anywhere
        return None

    def _run(self, socket: int) -> None:
        while True:
            with self._cond:
                while self._pending == 0 and not self._stop:
                    self._cond.wait(timeout=0.5)
                if self._stop and self._pending == 0:
                    return
                picked = self._pick(socket)
            if picked is None:
                continue
            cache, batch = picked
            bulk = getattr(cache, "_evict_slots", None)
            try:
                if bulk is not None and len(batch) > 1:
                    bulk(batch)
                else:
                    for slot in batch:
                        cache._evict_slot(slot)
            finally:
                for _ in batch:
                    cache._complete_eviction()

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout=2.0)
