"""The paper's baseline caching policies — I/O *staging* strategies.

All four intentionally buffer data "for sufficiently long" and pay for it on
the critical path, which is precisely what the paper's motivational study
(§3) demonstrates:

  * **PMBD**     — multi sub-buffers; when a sub-buffer is 100% full the whole
                   sub-buffer is drained *synchronously* before the write.
  * **PMBD-70**  — faithful to the PMBD literature: a *syncer daemon* drains a
                   sub-buffer once it crosses the 70% watermark; the foreground
                   stalls only at 100%.
  * **LRU**      — single pool; on full, evict the least-recently-used slot to
                   BTT and then write into the vacated slot (the 2-step write).
  * **Co-Active**— port of Sun et al. [61]: bloom-filter-based cold/hot
                   separation, dirty & clean lists, and a background thread
                   that *proactively* evicts cold dirty blocks when the device
                   has been idle; on pressure it drops clean blocks first.

They share the interface of :class:`repro_torch.core.cache.CaitiCache` (write /
read / flush / fsync / metrics) so every benchmark treats policies uniformly.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

from .btt import BTT
from .metrics import Metrics


class _StagingBase:
    """Common slot pool + bookkeeping for staging policies."""

    def __init__(self, btt: BTT, capacity_bytes: int = 512 << 20,
                 metrics: Metrics | None = None) -> None:
        self.btt = btt
        self.block_size = btt.block_size
        self.n_slots = max(1, capacity_bytes // self.block_size)
        self._buf = np.zeros((self.n_slots, self.block_size), dtype=np.uint8)
        self.metrics = metrics or Metrics()
        self._lock = threading.RLock()
        self._map: dict[int, int] = {}          # lba -> slot idx
        self._owner: list[int] = [-1] * self.n_slots  # slot -> lba
        self._free: list[int] = list(range(self.n_slots))
        self._dirty: set[int] = set()            # slot idxs needing writeback

    # -- helpers ------------------------------------------------------------
    def _writeback(self, slot: int) -> None:
        lba = self._owner[slot]
        if lba >= 0 and slot in self._dirty:
            self.btt.write(lba, self._buf[slot])
            self._dirty.discard(slot)

    def _drop(self, slot: int) -> None:
        lba = self._owner[slot]
        if lba >= 0:
            self._map.pop(lba, None)
        self._owner[slot] = -1
        self._free.append(slot)

    def _install(self, lba: int, src: np.ndarray) -> int:
        slot = self._free.pop()
        self._owner[slot] = lba
        self._map[lba] = slot
        t1 = time.perf_counter_ns()
        self._buf[slot, :src.nbytes] = src
        self.metrics.add_ns("cache_write_only", time.perf_counter_ns() - t1)
        self._dirty.add(slot)
        return slot

    # -- shared read/flush ----------------------------------------------------
    def read(self, lba: int, out: np.ndarray | None = None) -> np.ndarray:
        with self._lock:
            slot = self._map.get(lba)
            if slot is not None:
                self.metrics.bump("read_hits")
                self._touch_read(lba, slot)
                if out is not None:
                    out[:] = self._buf[slot]
                    return out
                return self._buf[slot].copy()
        self.metrics.bump("read_misses")
        return self.btt.read(lba, out=out)

    def _touch_read(self, lba: int, slot: int) -> None:  # LRU override point
        pass

    def flush(self, fua: bool = False) -> int:
        with self.metrics.timer("cache_flush"):
            with self._lock:
                for slot in list(self._dirty):
                    self._writeback(slot)
            if fua:
                self.btt.flush()
        return 0

    def fsync(self) -> int:
        return self.flush(fua=True)

    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.n_slots

    def close(self) -> None:
        self.flush(fua=True)


class PMBDCache(_StagingBase):
    """PMBD with 100% watermark: full sub-buffer ⇒ synchronous drain."""

    def __init__(self, btt: BTT, capacity_bytes: int = 512 << 20,
                 n_subbuffers: int = 8, watermark: float = 1.0,
                 metrics: Metrics | None = None) -> None:
        super().__init__(btt, capacity_bytes, metrics)
        # every sub-buffer needs at least one slot (tiny test caches)
        self.n_sub = max(1, min(n_subbuffers, self.n_slots))
        self.watermark = watermark
        per = self.n_slots // self.n_sub
        # partition the slot pool into sub-buffers (free lists per sub)
        self._sub_free = [list(range(i * per, (i + 1) * per))
                          for i in range(self.n_sub)]
        self._free = []  # unused; sub-buffers own the slots

    def _sub_for(self, lba: int) -> int:
        return lba % self.n_sub

    def write(self, lba: int, data) -> int:
        t_req = time.perf_counter_ns()
        src = np.frombuffer(data, dtype=np.uint8)
        sub = self._sub_for(lba)
        with self._lock:
            slot = self._map.get(lba)
            if slot is not None:                      # hit: overwrite in place
                t1 = time.perf_counter_ns()
                self._buf[slot, :src.nbytes] = src
                self._dirty.add(slot)
                self.metrics.add_ns("cache_write_only",
                                    time.perf_counter_ns() - t1)
            else:
                if not self._sub_free[sub]:
                    # sub-buffer full: drain it entirely, on the critical path
                    with self.metrics.timer("cache_eviction_and_write"):
                        self._drain_sub(sub)
                self._free = self._sub_free[sub]
                self._install(lba, src)
        self.metrics.record_latency(time.perf_counter_ns() - t_req)
        return 0

    def _drain_sub(self, sub: int) -> None:
        per = self.n_slots // self.n_sub
        for slot in range(sub * per, (sub + 1) * per):
            if self._owner[slot] >= 0:
                self._writeback(slot)
                lba = self._owner[slot]
                self._map.pop(lba, None)
                self._owner[slot] = -1
                self._sub_free[sub].append(slot)


class PMBD70Cache(PMBDCache):
    """PMBD per the literature: syncer daemon drains at the 70% watermark."""

    def __init__(self, btt: BTT, capacity_bytes: int = 512 << 20,
                 n_subbuffers: int = 8, metrics: Metrics | None = None) -> None:
        super().__init__(btt, capacity_bytes, n_subbuffers, watermark=0.7,
                         metrics=metrics)
        self._space = threading.Condition(self._lock)
        self._stop = False
        self._syncer = threading.Thread(target=self._syncer_loop, daemon=True,
                                        name="pmbd70-syncer")
        self._syncer.start()

    def _syncer_loop(self) -> None:
        per = self.n_slots // self.n_sub
        while not self._stop:
            drained = False
            for sub in range(self.n_sub):
                with self._lock:
                    used = per - len(self._sub_free[sub])
                    if used >= self.watermark * per:
                        self._drain_sub(sub)
                        self._space.notify_all()
                        drained = True
            if not drained:
                time.sleep(0.0002)

    def write(self, lba: int, data) -> int:
        t_req = time.perf_counter_ns()
        src = np.frombuffer(data, dtype=np.uint8)
        sub = self._sub_for(lba)
        with self._lock:
            slot = self._map.get(lba)
            if slot is not None:
                t1 = time.perf_counter_ns()
                self._buf[slot, :src.nbytes] = src
                self._dirty.add(slot)
                self.metrics.add_ns("cache_write_only",
                                    time.perf_counter_ns() - t1)
            else:
                # stall only at 100%: wait for the syncer to free space
                t1 = time.perf_counter_ns()
                stalled = False
                while not self._sub_free[sub]:
                    stalled = True
                    self._space.wait(timeout=0.01)
                if stalled:
                    self.metrics.add_ns("cache_eviction_and_write",
                                        time.perf_counter_ns() - t1)
                self._free = self._sub_free[sub]
                self._install(lba, src)
        self.metrics.record_latency(time.perf_counter_ns() - t_req)
        return 0

    def close(self) -> None:
        self._stop = True
        self._syncer.join(timeout=2.0)
        super().close()


class LRUCache(_StagingBase):
    """Classic LRU staging cache: 2-step write on full (paper §3)."""

    def __init__(self, btt: BTT, capacity_bytes: int = 512 << 20,
                 metrics: Metrics | None = None) -> None:
        super().__init__(btt, capacity_bytes, metrics)
        self._lru: OrderedDict[int, int] = OrderedDict()  # lba -> slot

    def _touch_read(self, lba: int, slot: int) -> None:
        self._lru.move_to_end(lba)

    def write(self, lba: int, data) -> int:
        t_req = time.perf_counter_ns()
        src = np.frombuffer(data, dtype=np.uint8)
        with self._lock:
            slot = self._map.get(lba)
            if slot is not None:
                t1 = time.perf_counter_ns()
                self._buf[slot, :src.nbytes] = src
                self._dirty.add(slot)
                self.metrics.add_ns("cache_write_only",
                                    time.perf_counter_ns() - t1)
                self._lru.move_to_end(lba)
            else:
                if not self._free:
                    # 2-step write: evict LRU to PMem, then fill the slot
                    with self.metrics.timer("cache_eviction_and_write"):
                        old_lba, old_slot = self._lru.popitem(last=False)
                        self._writeback(old_slot)
                        self._drop(old_slot)
                self._install(lba, src)
                self._lru[lba] = self._map[lba]
        self.metrics.record_latency(time.perf_counter_ns() - t_req)
        return 0


class CoActiveCache(_StagingBase):
    """Co-Active [61] ported to the PMem block device (as in the paper §5).

    Cold/hot separation via a counting bloom filter (2 B/slot budget in the
    paper); dirty + clean lists; proactive eviction of cold dirty blocks when
    the device is idle; clean blocks are dropped first under pressure.
    """

    _BLOOM_BITS = 16

    def __init__(self, btt: BTT, capacity_bytes: int = 512 << 20,
                 idle_us: float = 200.0, metrics: Metrics | None = None) -> None:
        super().__init__(btt, capacity_bytes, metrics)
        self._bloom = np.zeros(1 << self._BLOOM_BITS, dtype=np.uint8)
        self._dirty_lru: OrderedDict[int, int] = OrderedDict()  # lba -> slot
        self._clean_lru: OrderedDict[int, int] = OrderedDict()
        self._last_io_ns = time.perf_counter_ns()
        self._idle_ns = int(idle_us * 1e3)
        self._stop = False
        self._bg = threading.Thread(target=self._idle_evictor, daemon=True,
                                    name="coactive-bg")
        self._bg.start()

    def _heat(self, lba: int) -> int:
        h = (lba * 0x9E3779B1) & ((1 << self._BLOOM_BITS) - 1)
        return int(self._bloom[h])

    def _warm(self, lba: int) -> None:
        h = (lba * 0x9E3779B1) & ((1 << self._BLOOM_BITS) - 1)
        if self._bloom[h] < 255:
            self._bloom[h] += 1

    def _idle_evictor(self) -> None:
        """Proactively transit cold dirty blocks to PMem while idle."""
        while not self._stop:
            now = time.perf_counter_ns()
            did = False
            if now - self._last_io_ns > self._idle_ns:
                with self._lock:
                    # pick the coldest dirty block (front of LRU, low heat)
                    for lba in list(self._dirty_lru.keys())[:4]:
                        if self._heat(lba) <= 2:
                            slot = self._dirty_lru.pop(lba)
                            self._writeback(slot)
                            self._clean_lru[lba] = slot
                            did = True
                self.metrics.bump("proactive_evictions", 1 if did else 0)
            if not did:
                time.sleep(0.0002)

    def write(self, lba: int, data) -> int:
        t_req = time.perf_counter_ns()
        src = np.frombuffer(data, dtype=np.uint8)
        with self._lock:
            self._last_io_ns = time.perf_counter_ns()
            self._warm(lba)
            slot = self._map.get(lba)
            if slot is not None:
                t1 = time.perf_counter_ns()
                self._buf[slot, :src.nbytes] = src
                self.metrics.add_ns("cache_write_only",
                                    time.perf_counter_ns() - t1)
                self._dirty.add(slot)
                self._clean_lru.pop(lba, None)
                self._dirty_lru[lba] = slot
                self._dirty_lru.move_to_end(lba)
            else:
                if not self._free:
                    self._make_room()
                self._install(lba, src)
                self._dirty_lru[lba] = self._map[lba]
        self.metrics.record_latency(time.perf_counter_ns() - t_req)
        return 0

    def _make_room(self) -> None:
        # prefer dropping a clean block (no I/O); else sync-evict coldest dirty
        if self._clean_lru:
            lba, slot = self._clean_lru.popitem(last=False)
            self._drop(slot)
            return
        with self.metrics.timer("cache_eviction_and_write"):
            lba, slot = self._dirty_lru.popitem(last=False)
            self._writeback(slot)
            self._drop(slot)

    def _touch_read(self, lba: int, slot: int) -> None:
        self._warm(lba)
        if lba in self._dirty_lru:
            self._dirty_lru.move_to_end(lba)
        elif lba in self._clean_lru:
            self._clean_lru.move_to_end(lba)
        self._last_io_ns = time.perf_counter_ns()

    def flush(self, fua: bool = False) -> int:
        with self.metrics.timer("cache_flush"):
            with self._lock:
                # Co-Active's complex list surgery makes its flush expensive
                # (the paper measures 1.9x LRU/PMBD flush time)
                for lba in list(self._dirty_lru.keys()):
                    slot = self._dirty_lru.pop(lba)
                    self._writeback(slot)
                    self._clean_lru[lba] = slot
            if fua:
                self.btt.flush()
        return 0

    def close(self) -> None:
        self._stop = True
        self._bg.join(timeout=2.0)
        super().close()
