"""Caiti — caching with I/O transit (the paper's core contribution, §4).

Structure (Figure 4):
  * one contiguous DRAM buffer partitioned into uniform *slots*;
  * slot headers carry {slot number, lba, state, WBQ link, lock};
  * logical *cache sets* indexed by ``hash(lba)`` — no mapping table;
  * a single *global free set* (CAS-style pop/push) feeding all sets;
  * slot states: Free → Pending → Valid → Evicting → Free.

Write policies (§4.3.1, Algorithm 1):
  * **eager eviction** — the instant a slot turns Valid it is enqueued on its
    set's write-back queue (WBQ) and a background pool thread transits it to
    the PMem-based block device (BTT);
  * **conditional bypass** — a write miss against a full cache goes straight
    to BTT (one PMem write beats evict-then-fill = PMem write + DRAM write).

Reading policy (§4.3.2): serve Valid/Evicting hits from DRAM, redirect misses
to BTT, never allocate on read miss (writes are prioritized).  An optional
``read_tier`` (``repro_torch.volume.ReadTier``) layers a *clean* DRAM read cache
under the transit cache: probed after a transit miss, filled from the BTT
read (fenced against racing writes), re-populated by eviction writebacks,
and invalidated by every write before it stages — the transit cache keeps
the write path exactly as the paper specifies, the tier only shortens the
read-miss path.

Locking discipline (deadlock-free order): a foreground thread takes
``set.lock`` only for table/WBQ surgery and *releases it before* taking
``slot.lock``; it re-validates ``slot.lba``/state after acquiring and retries
if the slot was recycled underneath it.  The evictor holds ``slot.lock``
across the BTT write (so a racing write/read to the same lba waits for the
persist to finish — the paper's rule for the Evicting state) and takes
``set.lock`` only after, for removal.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

from .btt import BTT
from .metrics import Metrics

# Slot states (paper §4.2)
FREE, PENDING, VALID, EVICTING = range(4)
_STATE_NAMES = ("Free", "Pending", "Valid", "Evicting")


class SlotHeader:
    __slots__ = ("idx", "lba", "state", "lock", "set_idx", "queued")

    def __init__(self, idx: int) -> None:
        self.idx = idx
        self.lba = -1
        self.state = FREE
        self.lock = threading.Lock()
        self.set_idx = -1
        self.queued = False


class CacheSet:
    __slots__ = ("lock", "table", "wbq")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.table: dict[int, SlotHeader] = {}   # lba -> slot
        self.wbq: deque[SlotHeader] = deque()    # write-back queue


def _hash_lba(lba: int) -> int:
    """Cheap mixer so striding writes still spread across sets."""
    x = (lba * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    return x >> 17


@dataclass
class CaitiConfig:
    capacity_bytes: int = 512 << 20
    block_size: int = 4096
    n_sets: int = 256
    n_workers: int = 4            # background eviction pool
    eager_eviction: bool = True   # 'w/o EE' ablation when False
    conditional_bypass: bool = True  # 'w/o BP' ablation when False

    @property
    def n_slots(self) -> int:
        return max(1, self.capacity_bytes // self.block_size)


class CaitiCache:
    """The I/O transit cache in front of a BTT block device.

    ``evict_pool`` (optional) hands background write-back to a shared
    multi-device pool (``repro_torch.volume.SharedEvictionPool``) instead of
    per-device worker threads — the volume manager drains all shards from
    one set of eviction cores.  ``bypass_hook`` (optional) extends the
    paper's conditional bypass with a *global* condition: when the hook
    returns True a write miss transits straight to BTT even though this
    shard still has free slots (the volume's aggregate-staged watermark).
    ``read_tier`` (optional, possibly shared across shards) serves read
    misses from clean DRAM slots; ``tier_ns`` namespaces this device's
    lbas inside a shared tier (the volume passes its shard index).
    """

    def __init__(self, btt: BTT, cfg: CaitiConfig | None = None,
                 metrics: Metrics | None = None, evict_pool=None,
                 bypass_hook=None, read_tier=None, tier_ns: int = 0,
                 admission=None) -> None:
        self.btt = btt
        self.cfg = cfg or CaitiConfig(block_size=btt.block_size)
        assert self.cfg.block_size == btt.block_size
        self.metrics = metrics or Metrics()
        self.bypass_hook = bypass_hook
        # unified admission layer (repro_torch.volume.AdmissionPolicy): scan
        # detection decides read-tier fills; the volume also routes its
        # aggregate bypass watermark through it (via bypass_hook)
        self.admission = admission
        self.read_tier = read_tier
        self.tier_ns = tier_ns
        n = self.cfg.n_slots
        self._buf = np.zeros((n, self.cfg.block_size), dtype=np.uint8)
        self._slots = [SlotHeader(i) for i in range(n)]
        self._sets = [CacheSet() for _ in range(self.cfg.n_sets)]
        # global free set — deque.pop/append are atomic under the GIL, the
        # analogue of the paper's CAS alloc/dealloc
        self._free: deque[SlotHeader] = deque(self._slots)
        # flush accounting: flush waits until everything enqueued before it
        # has been written back
        self._evict_lock = threading.Lock()
        self._evict_cond = threading.Condition(self._evict_lock)
        self._enqueued = 0
        self._completed = 0
        # one-shot drain waiters: (target_enqueued, callback) fired from
        # the eviction completion path once everything enqueued at
        # registration time has been written back — the async frontend
        # completes flush tickets here instead of parking a thread in
        # flush()
        self._drain_waiters: list[tuple[int, object]] = []
        # background pool: private threads, or a shared cross-shard pool
        self._pool = evict_pool
        self._work: queue.SimpleQueue[SlotHeader | None] = queue.SimpleQueue()
        self._stop = False
        if evict_pool is not None:
            evict_pool.register(self)
            self._workers = []
        else:
            self._workers = [
                threading.Thread(target=self._evict_worker, daemon=True,
                                 name=f"caiti-evict-{i}")
                for i in range(self.cfg.n_workers)
            ]
            for w in self._workers:
                w.start()

    # ----------------------------------------------------------- internals
    def _set_for(self, lba: int) -> CacheSet:
        return self._sets[_hash_lba(lba) % self.cfg.n_sets]

    def cache_full(self) -> bool:
        return not self._free

    def _alloc_slot(self) -> SlotHeader | None:
        try:
            return self._free.pop()      # CAS-style pop
        except IndexError:
            return None

    def _notify_eviction(self, sh: SlotHeader) -> None:
        with self._evict_lock:
            self._enqueued += 1
        if self._pool is not None:
            self._pool.submit(self, sh)
        else:
            self._work.put(sh)

    def staged_slots(self) -> int:
        """Slots currently occupied (Pending/Valid/Evicting)."""
        return len(self._slots) - len(self._free)

    def _complete_eviction(self, n: int = 1) -> None:
        with self._evict_cond:
            self._completed += n
            self._evict_cond.notify_all()
            ready = [cb for tgt, cb in self._drain_waiters
                     if self._completed >= tgt]
            if ready:
                self._drain_waiters = [
                    (tgt, cb) for tgt, cb in self._drain_waiters
                    if self._completed < tgt]
        for cb in ready:             # outside the lock: callbacks may
            cb()                     # re-enter the cache/engine

    def add_drain_waiter(self, cb) -> bool:
        """Register a one-shot callback fired (from the eviction
        completion path) once every writeback enqueued SO FAR has
        landed.  Returns False — without registering — when the cache is
        already drained, so the caller can count it complete inline."""
        with self._evict_cond:
            if self._completed >= self._enqueued:
                return False
            self._drain_waiters.append((self._enqueued, cb))
            return True

    # ------------------------------------------------------- write (Alg. 1)
    def write(self, lba: int, data) -> int:
        t_req = time.perf_counter_ns()
        src = np.frombuffer(data, dtype=np.uint8)
        # writes invalidate the clean read tier FIRST (fence in-flight
        # fills), then stage; the eviction writeback re-populates it
        if self.read_tier is not None:
            self.read_tier.invalidate((self.tier_ns, lba))
        while True:
            t0 = time.perf_counter_ns()
            cs = self._set_for(lba)                       # L1: hash -> set
            with cs.lock:                                 # L2-3: probe WBQ set
                sh = cs.table.get(lba)
            self.metrics.add_ns("cache_metadata", time.perf_counter_ns() - t0)
            if sh is not None:
                # ---- write hit (L5-9). Take the slot lock; if the slot was
                # recycled while we waited (eager eviction is fast!), retry.
                with sh.lock:
                    if sh.lba != lba or sh.state not in (VALID, PENDING):
                        continue
                    sh.state = PENDING
                    t1 = time.perf_counter_ns()
                    self._buf[sh.idx, :src.nbytes] = src
                    sh.state = VALID
                    self.metrics.add_ns("cache_write_only",
                                        time.perf_counter_ns() - t1)
                    # enqueue under the slot lock: the evictor cannot observe
                    # the slot between Valid and queued (no recycle window)
                    self._enqueue_for_eviction(cs, sh)
                break
            # ---- write miss.  The volume's global watermark extends the
            # paper's bypass condition: under aggregate staging pressure a
            # write transits straight to BTT even with local slots free.
            globally_full = (self.cfg.conditional_bypass
                             and self.bypass_hook is not None
                             and self.bypass_hook())
            sh = None if globally_full else self._alloc_slot()
            if sh is None:
                if self.cfg.conditional_bypass:
                    # L20-22: cache full -> transit straight to PMem
                    with self.metrics.timer("conditional_bypass"):
                        self.btt.write(lba, src)
                    # second fence: a reader that prepared a fill between
                    # the head-of-write invalidate and this BTT write may
                    # hold the old block — no eviction will fix it, so
                    # invalidate again now the new data is on media
                    if self.read_tier is not None:
                        self.read_tier.invalidate((self.tier_ns, lba))
                    self.metrics.bump("bypass_writes")
                    self.metrics.record_latency(time.perf_counter_ns() - t_req)
                    return 0
                # 'w/o BP' ablation: stall — evict someone on the critical path
                with self.metrics.timer("cache_eviction_and_write"):
                    self._evict_one_sync()
                continue
            with sh.lock:
                sh.lba = lba
                sh.set_idx = _hash_lba(lba) % self.cfg.n_sets
                sh.state = PENDING                         # L14
                # verify no racing miss installed this lba meanwhile (L12-16)
                with cs.lock:
                    other = cs.table.get(lba)
                    if other is not None:
                        # lose the race: return our slot and retry as a hit
                        sh.state = FREE
                        sh.lba = -1
                        self._free.append(sh)
                        continue
                    cs.table[lba] = sh
                t1 = time.perf_counter_ns()
                self._buf[sh.idx, :src.nbytes] = src       # L16
                sh.state = VALID
                self.metrics.add_ns("cache_write_only",
                                    time.perf_counter_ns() - t1)
                self._enqueue_for_eviction(cs, sh)         # L18-19
            break
        self.metrics.record_latency(time.perf_counter_ns() - t_req)
        return 0

    def _enqueue_for_eviction(self, cs: CacheSet, sh: SlotHeader) -> None:
        t0 = time.perf_counter_ns()
        with cs.lock:
            if not sh.queued:
                sh.queued = True
                cs.wbq.append(sh)
                queued = True
            else:
                queued = False
        self.metrics.add_ns("wbq_enqueue", time.perf_counter_ns() - t0)
        if queued and self.cfg.eager_eviction:
            self._notify_eviction(sh)                      # L26

    # --------------------------------------------------------------- read
    def probe(self, lba: int) -> str | None:
        """Non-mutating guess of where a read of ``lba`` would be served
        from ('transit' | 'tier' | None-for-backend) — no hit counters,
        no CLOCK second chance, no scan-detector update.  The volume
        prices tier-aware WFQ read admission with it BEFORE walking the
        stack; a racing write/eviction can invalidate the guess, which
        the post-service settle (``WFQGate.charge``) absorbs."""
        cs = self._set_for(lba)
        with cs.lock:
            sh = cs.table.get(lba)
        if sh is not None and sh.lba == lba \
                and sh.state in (VALID, PENDING, EVICTING):
            return "transit"
        if self.read_tier is not None \
                and (self.tier_ns, lba) in self.read_tier:
            return "tier"
        return None

    def read(self, lba: int, out: np.ndarray | None = None) -> np.ndarray:
        return self.read_ex(lba, out=out)[0]

    def read_ex(self, lba: int, out: np.ndarray | None = None):
        """Read one block and report where it was served from:
        ``(data, source)`` with source 'transit' | 'tier' | 'backend'.
        The volume uses the source for tier-aware QoS pricing (a DRAM
        hit must not debit a tenant like a PMem round trip)."""
        cs = self._set_for(lba)
        with cs.lock:
            sh = cs.table.get(lba)
        if sh is not None:
            with sh.lock:   # waits out Pending writes / in-flight persists
                if sh.lba == lba and sh.state in (VALID, PENDING, EVICTING):
                    self.metrics.bump("read_hits")
                    if out is not None:
                        out[:] = self._buf[sh.idx]
                        return out, "transit"
                    return self._buf[sh.idx].copy(), "transit"
        adm = self.admission
        tier = self.read_tier
        token = None
        fill = False
        if tier is not None:
            key = (self.tier_ns, lba)
            hit = tier.lookup(key, out=out)
            if hit is not None:
                if adm is not None:        # hits still feed the detector
                    adm.observe_read(self.tier_ns, lba)
                self.metrics.bump("read_tier_hits")
                return hit, "tier"
            # sequential-scan bypass: a giant scan's fills would flush
            # the tier's hot set for blocks it never revisits.  One lock
            # round trip: observe + decide together.
            fill = adm is None or adm.observe_and_admit(self.tier_ns, lba)
            if fill:
                token = tier.prepare(key)  # fence the fill against writes
            else:
                self.metrics.bump("tier_fill_bypassed")
        elif adm is not None:
            adm.observe_read(self.tier_ns, lba)
        self.metrics.bump("read_misses")
        data = self.btt.read(lba, out=out)
        if tier is not None and fill and tier.insert(key, data, token=token):
            self.metrics.bump("read_tier_fills")
        return data, "backend"

    # ----------------------------------------------------------- eviction
    def _evict_worker(self) -> None:
        while True:
            sh = self._work.get()
            if sh is None:
                return
            self._evict_slot(sh)
            self._complete_eviction()

    def _evict_slot(self, sh: SlotHeader) -> None:
        """Transit one slot to the device (background thread, Fig. 4 step 5)."""
        with sh.lock:
            cs = self._sets[sh.set_idx] if sh.set_idx >= 0 else None
            if sh.state != VALID or cs is None:
                # recycled or re-claimed; clear queued flag under set lock
                if cs is not None:
                    with cs.lock:
                        sh.queued = False
                        try:
                            cs.wbq.remove(sh)
                        except ValueError:
                            pass
                return
            sh.state = EVICTING
            lba = sh.lba
            # hold the slot lock across the persist: a racing writer/reader of
            # this lba waits for BTT completion (block-level atomicity intact)
            self.btt.write(lba, self._buf[sh.idx])
            if self.read_tier is not None:
                # writeback population: the block leaves the transit cache
                # but stays warm in the clean tier.  Invalidate first so a
                # reader's in-flight stale fill is fenced off, then install
                # the authoritative just-persisted image.
                key = (self.tier_ns, lba)
                self.read_tier.invalidate(key)
                self.read_tier.insert(key, self._buf[sh.idx])
            with cs.lock:
                if cs.table.get(lba) is sh:
                    del cs.table[lba]
                sh.queued = False
                try:
                    cs.wbq.remove(sh)
                except ValueError:
                    pass
            sh.state = FREE
            sh.lba = -1
            sh.set_idx = -1
        self._free.append(sh)
        self.metrics.bump("bg_evictions")

    def _evict_one_sync(self) -> None:
        """'w/o BP' stall path: drain one queued slot on the critical path."""
        for cs in self._sets:
            with cs.lock:
                sh = cs.wbq[0] if cs.wbq else None
            if sh is not None:
                self._evict_slot(sh)
                return
        time.sleep(0)   # nothing queued yet; let background threads run

    # -------------------------------------------------------------- flush
    def kick_drain(self) -> None:
        """Push every queued WBQ entry to the eviction pool NOW — the
        staging-style drain step a flush needs when eager eviction is
        off (with it on, writes already enqueued themselves).  Shared by
        :meth:`flush` and the async frontend's flush tickets, which
        must kick before registering drain waiters or a ``caiti-noee``
        flush ticket would complete with everything still staged."""
        if self.cfg.eager_eviction:
            return
        for cs in self._sets:
            with cs.lock:
                pending = [sh for sh in cs.wbq]
            for sh in pending:
                self._notify_eviction(sh)

    def flush(self, fua: bool = False) -> int:
        """REQ_PREFLUSH handling (§4.4): drain all WBQ entries, wait for BTT.

        Thanks to eager eviction this is almost always a no-op wait.
        """
        with self.metrics.timer("cache_flush"):
            self.kick_drain()
            with self._evict_cond:
                target = self._enqueued
                while self._completed < target:
                    self._evict_cond.wait(timeout=0.5)
            if fua:
                self.btt.flush()   # durable commit (msync for file pools)
        return 0

    def fsync(self) -> int:
        return self.flush(fua=True)

    # ------------------------------------------------------------- stats
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / max(1, len(self._slots))

    def close(self) -> None:
        self.flush(fua=True)
        for _ in self._workers:
            self._work.put(None)
        for w in self._workers:
            w.join(timeout=2.0)
