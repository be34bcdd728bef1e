"""DRAM read tier + replica resync — the read half of the layered I/O stack.

The paper's transit cache is deliberately *write-only* (§4.3.2: never
allocate a slot on a read miss — writes are prioritized because PMem
writes are the expensive direction).  That is right for the write path
but leaves read-heavy serving workloads paying a full BTT/PMem round
trip on every access.  NVCache (Dulong et al.) and the PMem I/O
primitives study (van Renen et al.) both show a clean DRAM read tier in
front of NVM pays for itself once reads dominate.

:class:`ReadTier` is that tier: a CLOCK (second-chance) cache over
uniform slots holding only CLEAN data — blocks that are already durable
on the device below.  It therefore needs **no journal interplay** and no
flush handling: losing it costs hits, never data.  Consistency is a
three-rule protocol:

  * **populated** on read miss (the fill) and on transit-eviction
    writeback (the block just left the write cache but is still warm);
  * **invalidated** by every write before the write enters the transit
    cache — the transit cache is probed before the tier, so readers see
    the newest staged copy, and the eviction writeback re-populates the
    tier with the new data;
  * fills are **fenced**: a fill races an invalidate when a reader is
    still copying old data out of the backend while a writer updates the
    block.  ``prepare()`` hands the reader a fence token before it
    touches the backend; ``insert()`` with a stale token is dropped.
    Writeback/repair inserts carry no token (their data is authoritative).

:class:`ReplicaResyncer` is the repair half of degraded reads: when a
replicated volume serves a read from a replica because the primary shard
failed verification, the divergent block is queued here and a background
worker rewrites the bad copies from the good one.  The resyncer plugs
into the volume's :class:`~repro_torch.volume.evict_pool.SharedEvictionPool`
as just another drain participant, so repair traffic shares the eviction
cores (and their per-socket banks) instead of spawning a private pool.
"""
from __future__ import annotations

import threading
from collections import deque

import numpy as np


class ReadTier:
    """CLOCK/second-chance read-mostly cache over uniform clean slots.

    Two storage modes share the one replacement policy:

      * **block mode** (``block_size`` set): a preallocated
        ``(n_slots, block_size)`` uint8 buffer — the volume/device tier;
      * **object mode** (``block_size=None``): slots hold arbitrary
        Python objects (e.g. dequantized KV pages) — the serving tier.

    Keys are opaque hashables; multi-device volumes use ``(shard, lba)``
    so one tier fronts every shard.
    """

    def __init__(self, capacity_bytes: int = 64 << 20,
                 block_size: int | None = 4096, *,
                 n_slots: int | None = None, metrics=None) -> None:
        if n_slots is None:
            assert block_size, "object mode needs an explicit n_slots"
            n_slots = max(1, capacity_bytes // block_size)
        self.block_size = block_size
        self.n_slots = n_slots
        self.metrics = metrics
        # optional AdmissionPolicy: read-miss fills (token path) from
        # sequential scans are dropped so they cannot flush the hot set.
        # The volume installs its unified policy here; direct users of
        # the tier get the same protection as cache-fronted reads.
        self.admission = None
        self._buf = (np.zeros((n_slots, block_size), dtype=np.uint8)
                     if block_size else None)
        self._objs: list = [None] * (0 if block_size else n_slots)
        self._keys: list = [None] * n_slots
        self._ref = bytearray(n_slots)
        self._map: dict = {}                   # key -> slot index
        # fill fences, key -> [epoch, outstanding_fills].  An entry exists
        # ONLY while a prepared fill is in flight (prepare creates it,
        # the matching insert retires it), so memory is bounded by fill
        # concurrency, not by the written address space.  Invalidation
        # with no fill in flight needs no fence: there is nothing racing.
        self._fence: dict = {}
        self._hand = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.invalidations = 0
        self.rejected_fills = 0

    # ------------------------------------------------------------- lookup
    def lookup(self, key, out: np.ndarray | None = None):
        """Return the cached block/object (second chance granted), or None."""
        with self._lock:
            slot = self._map.get(key)
            if slot is None:
                self.misses += 1
                return None
            self._ref[slot] = 1
            self.hits += 1
            if self.metrics is not None:
                self.metrics.bump("read_tier_hits")
            if self.block_size is None:
                return self._objs[slot]
            if out is not None:
                out[:] = self._buf[slot]
                return out
            return self._buf[slot].copy()

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._map

    # -------------------------------------------------------------- fills
    def prepare(self, key) -> int:
        """Fence token for a read-miss fill: grab BEFORE reading the
        backend, pass to insert() so a racing write drops the stale fill.
        Every prepare() MUST be paired with exactly one insert(token=)."""
        with self._lock:
            st = self._fence.get(key)
            if st is None:
                st = self._fence[key] = [0, 0]
            st[1] += 1
            return st[0]

    def insert(self, key, data, token: int | None = None) -> bool:
        """Install ``data`` under ``key``; returns False if fenced off or
        denied by the admission policy (sequential-scan fills).  Writeback
        and repair inserts (no token) are always admitted — their data is
        authoritative and already paid for."""
        with self._lock:
            if token is not None:
                st = self._fence.get(key)
                stale = st is not None and st[0] != token
                if st is not None:            # retire this fill's fence ref
                    st[1] -= 1
                    if st[1] <= 0:
                        del self._fence[key]
                if stale:
                    self.rejected_fills += 1
                    return False
                if self.admission is not None \
                        and not self.admission.admit_key_fill(key):
                    self.rejected_fills += 1
                    return False
            slot = self._map.get(key)
            if slot is None:
                slot = self._clock_victim()
                old = self._keys[slot]
                if old is not None:
                    del self._map[old]
                self._keys[slot] = key
                self._map[key] = slot
            self._ref[slot] = 1
            if self.block_size is None:
                self._objs[slot] = data
            else:
                src = np.frombuffer(bytes(data), dtype=np.uint8) \
                    if not isinstance(data, np.ndarray) else data
                self._buf[slot, :src.size] = src.reshape(-1)[:self.block_size]
            self.fills += 1
            if self.metrics is not None:
                self.metrics.bump("read_tier_fills")
            return True

    def _clock_victim(self) -> int:
        """Second chance: sweep the hand, clearing ref bits, until a slot
        with a clear bit comes up (bounded by two sweeps)."""
        for _ in range(2 * self.n_slots):
            slot = self._hand
            self._hand = (self._hand + 1) % self.n_slots
            if self._keys[slot] is None or not self._ref[slot]:
                return slot
            self._ref[slot] = 0
        return self._hand                       # pragma: no cover

    # ------------------------------------------------------- invalidation
    def invalidate(self, key) -> None:
        """Drop ``key``; advance its fence if a fill is in flight."""
        with self._lock:
            st = self._fence.get(key)
            if st is not None:
                st[0] += 1
            slot = self._map.pop(key, None)
            if slot is not None:
                self._keys[slot] = None
                self._ref[slot] = 0
                if self.block_size is None:
                    self._objs[slot] = None
                self.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
            self._fence.clear()
            self._keys = [None] * self.n_slots
            self._ref = bytearray(self.n_slots)
            if self.block_size is None:
                self._objs = [None] * self.n_slots

    # --------------------------------------------------------------- stats
    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "fills": self.fills, "invalidations": self.invalidations,
                "rejected_fills": self.rejected_fills,
                "resident": len(self), "n_slots": self.n_slots,
                "hit_rate": self.hit_rate()}


class ReplicaResyncer:
    """Background repair of divergent replica blocks.

    Foreground degraded reads (and ``resync()`` sweeps) enqueue logical
    lbas; repair work is drained either by the volume's shared eviction
    pool (``pool`` given — the resyncer registers as one more pool
    participant, optionally pinned to a NUMA ``socket`` bank) or by a
    private daemon thread.  Repair of one lba:

      1. read every copy straight from the shard BTTs (below the caches);
      2. pick the good copy — the volume's write-crc ledger arbitrates;
         with no ledger entry, majority vote, then primary, wins;
      3. rewrite the divergent copies via atomic BTT block writes and
         refresh/invalidate the read tier so later reads see the repair.

    Foreground I/O is never blocked: repairs touch the BTTs directly
    (block-atomic) and take NO volume locks — a pool worker must never
    wait on ``_txlock`` while ``fsync`` holds it waiting for the pool to
    drain (deadlock).  A foreground write racing a repair is detected by
    re-checking the crc ledger right before each rewrite; the residual
    window (write lands between recheck and rewrite) leaves one stale
    *replica* copy, which is exactly the divergence this machinery
    detects and repairs — reads stay correct (verification degrades
    around the stale copy) and the next scrub/resync converges it.
    """

    def __init__(self, volume, pool=None, *, socket: int = 0) -> None:
        self.vol = volume
        self.pool = pool
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queued: set[int] = set()         # dedup: lba -> at most one job
        self._inflight = 0
        self.repaired_blocks = 0
        self.clean_rechecks = 0
        self._stop = False
        self._work: deque[int] = deque()
        if pool is not None:
            pool.register(self, socket=socket)
            self._thread = None
        else:
            self._thread = threading.Thread(target=self._run, daemon=True,
                                            name="replica-resync")
            self._thread.start()

    # ----------------------------------------------------------- requests
    def request(self, lba: int) -> bool:
        """Queue one logical block for repair (deduplicated)."""
        with self._cond:
            if self._stop or lba in self._queued:
                return False
            self._queued.add(lba)
            self._inflight += 1
            if self.pool is not None:
                self.pool.submit(self, lba)
            else:
                self._work.append(lba)
                self._cond.notify()
        return True

    def resync(self, sample_every: int = 1) -> int:
        """Scrub-and-queue sweep: every divergent (shard, lba) pair found
        by the volume scrub becomes one repair request; returns how many
        lbas were queued."""
        n = 0
        for lba in {lba for lba, _r, _s, _l
                    in self.vol.scrub_replicas_detail(sample_every)}:
            if self.request(lba):
                n += 1
        return n

    def wait_idle(self, timeout: float = 30.0) -> bool:
        """Block until every queued repair completed (tests/sweeps)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)

    # ----------------------------------------- pool-participant interface
    # The shared pool drains participants through the same two hooks a
    # CaitiCache exposes, so repairs ride the eviction cores unchanged.
    def _evict_slot(self, lba: int) -> None:
        try:
            self._repair(lba)
        finally:
            with self._cond:
                self._queued.discard(lba)

    def _complete_eviction(self, n: int = 1) -> None:
        with self._cond:
            self._inflight -= n
            self._cond.notify_all()

    # ------------------------------------------------------------- repair
    def _repair(self, lba: int) -> None:
        vol = self.vol
        copies = []
        for r in range(vol.cfg.replicas):
            shard, local = vol._map(lba, r)
            copies.append((r, shard, local,
                           bytes(vol.shards[shard].impl.btt.read(local))))
        good = vol._pick_good_copy(lba, [c[3] for c in copies])
        if good is None:
            return                              # nothing trustworthy: leave it
        dirty = [c for c in copies if c[3] != good]
        if not dirty:
            self.clean_rechecks += 1
            return
        buf = np.frombuffer(good, dtype=np.uint8)
        for _r, shard, local, _data in dirty:
            # lock-free recheck: a foreground write that landed after our
            # reads owns the block now (its ledger crc no longer matches
            # our snapshot) — skip, the write made every copy consistent
            if vol._ledger_disagrees(lba, good):
                break
            vol.shards[shard].impl.btt.write(local, buf)
            tier = vol.read_tier
            if tier is not None:
                tier.invalidate((shard, local))
            self.repaired_blocks += 1
            if vol.metrics is not None:
                vol.metrics.bump("resync_repairs")

    # ----------------------------------------------------- private worker
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._work and not self._stop:
                    self._cond.wait(timeout=0.5)
                if self._stop and not self._work:
                    return
                lba = self._work.popleft()
            try:
                self._evict_slot(lba)
            finally:
                self._complete_eviction()

    def close(self) -> None:
        """Stop accepting repairs, drain what is already queued, and
        UNREGISTER from the shared pool — the volume closes its shard
        devices right after this, and a pool worker must never touch a
        closed device's mmap (even if the drain wait timed out)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            self._cond.wait_for(lambda: self._inflight == 0, timeout=10.0)
        if self.pool is not None:
            dropped = self.pool.unregister(self)
            if dropped:                  # never picked: settle accounting
                self._complete_eviction(len(dropped))
            with self._cond:             # stragglers already on a worker
                self._cond.wait_for(lambda: self._inflight == 0, timeout=2.0)
        if self._thread is not None:
            self._thread.join(timeout=2.0)
