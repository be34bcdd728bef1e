"""Discrete-event simulator for the paper's performance claims.

Why this exists: the container has ONE CPU core and a GIL — the paper's
mechanism (foreground cores fill DRAM slots while background cores drain
them to PMem) is physically unmeasurable as wall time here.  The policy
*state machines* mirror the threaded implementations in ``cache.py`` /
``policies.py`` (those remain the functional/crash-recovery ground truth);
this module re-executes them in **virtual time**, reproducing the paper's
Figure 2/3/5/6 contrasts deterministically.

Execution model (matches the paper's platform semantics):

  * a fio *job* is one submitting core; bios on a PMem block device execute
    INLINE in the submitter context, so a job's requests serialize on its
    core — ``iodepth`` controls closed-loop queueing (response time =
    queue wait + service), not extra parallelism;
  * io_submit batches amortize the syscall/stack cost across the depth
    (the paper's 'others' ≈54%% applies to depth-1 pwrite, §5.2);
  * PMem media is a shared resource: ``n_banks`` interleaved DIMMs, each a
    serial server — aggregate write bandwidth is the global bottleneck the
    background pool and foreground bypasses contend for;
  * Caiti's eviction pool = ``n_workers`` background cores, each a serial
    server that takes queued slots and writes them to PMem banks.

Cost model defaults (µs per 4 KB unless noted), calibrated so the
BTT : DAX : raw-PMem execution-time ratios match the paper's §3 study
(1.374 : 1.166 : 1) and the absolute BTT service sits in the few-µs regime
the paper's Fig. 2c shows:

  pmem_write_4k  1.95   (~2.1 GB/s/DIMM streaming store, FAST'20 [82])
  pmem_read_4k   0.75
  flog+map       0.45   (256 B entry + 8 B commit, media floor)
  btt_lane       0.35   (lane bookkeeping/locking of the kernel driver)
  dram_copy_4k   0.45   (~9 GB/s per-core memcpy)
  meta           0.15   (hash/slot-state work per cached write)
  bio_stack      2.20   (syscall+block-layer per submission, amortized by
                         min(iodepth, 16) under libaio batching)

All simulator tables print the cost model next to the results.
"""
from __future__ import annotations

import heapq
import itertools
from collections import defaultdict, deque
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class CostModel:
    pmem_write_4k: float = 1.95
    pmem_read_4k: float = 0.75
    flog_map: float = 0.45
    btt_lane: float = 0.35
    dram_copy_4k: float = 0.45
    meta: float = 0.15
    bio_stack: float = 2.20
    dax_extra: float = 0.39       # DAX file-system write path vs raw ext4
    n_banks: int = 6              # interleaved DIMMs (768GB = 6x128GB)

    def btt_write(self) -> float:
        return self.btt_lane + self.pmem_write_4k + self.flog_map

    def btt_read(self) -> float:
        return 0.2 + self.pmem_read_4k


class Bank:
    """One serial PMem DIMM server."""

    __slots__ = ("free_at",)

    def __init__(self) -> None:
        self.free_at = 0.0

    def serve(self, t: float, dur: float) -> float:
        start = max(t, self.free_at)
        self.free_at = start + dur
        return self.free_at


class Media:
    """The interleaved PMem DIMM set — the shared bandwidth bottleneck.

    ``scale`` is the fail-slow injection knob: a limping device serves
    every request ``scale`` times slower (media-level limplock — the
    DIMM set still completes everything, it just takes 10-100x longer),
    which is exactly the failure mode hedged reads exist for.
    """

    def __init__(self, cost: CostModel) -> None:
        self.banks = [Bank() for _ in range(cost.n_banks)]
        self._rr = 0
        self.scale = 1.0               # fail-slow multiplier (1.0 = healthy)

    def write(self, t: float, dur: float) -> float:
        """Serve one block write; returns completion time."""
        self._rr = (self._rr + 1) % len(self.banks)
        return self.banks[self._rr].serve(t, dur * self.scale)

    def earliest_free(self) -> float:
        return min(b.free_at for b in self.banks)


@dataclass
class SimMetrics:
    response_us: list = field(default_factory=list)
    t_arrive: list = field(default_factory=list)
    breakdown: dict = field(default_factory=lambda: defaultdict(float))
    counts: dict = field(default_factory=lambda: defaultdict(int))

    def lat(self, arrive: float, done: float) -> None:
        self.response_us.append(done - arrive)
        self.t_arrive.append(arrive)

    def mean(self) -> float:
        return float(np.mean(self.response_us)) if self.response_us else 0.0

    def pct(self, p: float) -> float:
        if not self.response_us:
            return 0.0
        return float(np.percentile(self.response_us, p))

    def makespan_s(self) -> float:
        if not self.response_us:
            return 0.0
        a = np.asarray(self.t_arrive)
        r = np.asarray(self.response_us)
        return float((a + r).max() / 1e6)


# ----------------------------------------------------------------- policies
class PolicyBase:
    """write(t, lba) -> completion time; the submitting core is occupied
    for the whole span (inline bio execution).  Policies charge media via
    the shared ``Media`` and may consult background worker fences."""

    def __init__(self, cost: CostModel, media: Media, n_slots: int) -> None:
        self.cost = cost
        self.media = media
        self.n_slots = n_slots
        self.resident: dict[int, float] = {}
        self.dirty: set[int] = set()
        self.m = SimMetrics()
        self.drain_until = 0.0        # foreground fence during async flush

    # helpers ---------------------------------------------------------------
    def _pmem_write(self, t: float, kind: str) -> float:
        end = self.media.write(t, self.cost.btt_write())
        self.m.breakdown[kind] += end - t
        return end

    def _dram_write(self, t: float, lba: int) -> float:
        end = t + self.cost.meta + self.cost.dram_copy_4k
        self.m.breakdown["cache_metadata"] += self.cost.meta
        self.m.breakdown["cache_write_only"] += self.cost.dram_copy_4k
        self.resident[lba] = end
        self.dirty.add(lba)
        return end

    def full(self) -> bool:
        return len(self.resident) >= self.n_slots

    def _drain_all(self, t: float) -> float:
        """Write back every dirty block through the media banks."""
        end = t
        for _ in range(len(self.dirty)):
            end = self.media.write(end, self.cost.btt_write())
        self.m.counts["flush_blocks"] += len(self.dirty)
        self.dirty.clear()
        self.resident.clear()
        return end

    # bio interface ----------------------------------------------------------
    def write(self, t: float, lba: int) -> float:     # pragma: no cover
        raise NotImplementedError

    def read(self, t: float, lba: int) -> float:
        if lba in self.resident:
            self.m.counts["read_hits"] += 1
            return t + self.cost.meta + self.cost.dram_copy_4k
        self.m.counts["read_misses"] += 1
        return t + self.cost.btt_read()

    def flush(self, t: float, sync: bool) -> float:
        """PREFLUSH.  sync=False is the ext4 tick (drain proceeds on the
        side but foreground writes fence on it); sync=True is fsync."""
        t0 = t
        end = self._drain_all(t)
        self.drain_until = max(self.drain_until, end)
        self.m.breakdown["cache_flush"] += end - t0
        return end if sync else t


class SimBTTOnly(PolicyBase):
    def __init__(self, cost, media):
        super().__init__(cost, media, 0)

    def write(self, t: float, lba: int) -> float:
        return self._pmem_write(t, "pmem_write")

    def read(self, t: float, lba: int) -> float:
        return t + self.cost.btt_read()

    def flush(self, t: float, sync: bool) -> float:
        return t


class SimRawDev(PolicyBase):
    def __init__(self, cost, media, dax: bool):
        super().__init__(cost, media, 0)
        self.extra = cost.dax_extra if dax else 0.0

    def write(self, t: float, lba: int) -> float:
        end = self.media.write(t, self.cost.pmem_write_4k + self.extra)
        self.m.breakdown["pmem_write"] += end - t
        return end

    def read(self, t: float, lba: int) -> float:
        return t + self.cost.pmem_read_4k + self.extra

    def flush(self, t: float, sync: bool) -> float:
        return t


class SimPMBD(PolicyBase):
    """Watermark staging; PMBD drains a full sub-buffer on the critical
    path, PMBD-70 lets a syncer daemon drain at 70% (stall only at 100%)."""

    def __init__(self, cost, media, n_slots, n_sub: int = 8,
                 watermark: float = 1.0, daemon: bool = False) -> None:
        super().__init__(cost, media, n_slots)
        self.n_sub = n_sub
        self.watermark = watermark
        self.daemon = daemon
        self.sub_res = [dict() for _ in range(n_sub)]
        self.sub_drain_at = [0.0] * n_sub
        self.syncer = Bank()          # ONE daemon thread, as in PMBD

    def _sub_drain(self, t: float, sub: int) -> float:
        end = t
        for lba in self.sub_res[sub]:
            end = self.media.write(end, self.cost.btt_write())
            self.dirty.discard(lba)
            self.resident.pop(lba, None)
        self.sub_res[sub].clear()
        return end

    def write(self, t: float, lba: int) -> float:
        t = max(t, self.drain_until)
        sub = lba % self.n_sub
        cap = max(1, self.n_slots // self.n_sub)
        res = self.sub_res[sub]
        if lba in res:
            return self._dram_write(t, lba)
        if self.daemon:
            if len(res) >= self.watermark * cap and t >= self.sub_drain_at[sub]:
                # the single syncer daemon drains sub-buffers one at a time
                start = max(t, self.syncer.free_at)
                end = self._sub_drain(start, sub)
                self.syncer.free_at = end
                self.sub_drain_at[sub] = end
                self.m.counts["daemon_drains"] += 1
            if len(res) >= cap:
                start = max(t, self.sub_drain_at[sub])
                self.m.breakdown["cache_eviction_and_write"] += start - t
                self.m.counts["stalls"] += 1
                t = start
        elif len(res) >= cap:
            end = self._sub_drain(t, sub)
            self.m.breakdown["cache_eviction_and_write"] += end - t
            self.m.counts["stalls"] += 1
            t = end
        end = self._dram_write(t, lba)
        res[lba] = end
        return end


class SimLRU(PolicyBase):
    """2-step write on full: evict the LRU block, then DRAM write."""

    def __init__(self, cost, media, n_slots) -> None:
        super().__init__(cost, media, n_slots)
        self.order: dict[int, None] = {}

    def write(self, t: float, lba: int) -> float:
        t = max(t, self.drain_until)
        if lba in self.resident:
            self.order.pop(lba, None)
            self.order[lba] = None
            return self._dram_write(t, lba)
        if self.full():
            victim = next(iter(self.order))
            del self.order[victim]
            self.resident.pop(victim, None)
            self.dirty.discard(victim)
            end = self._pmem_write(t, "cache_eviction_and_write")
            self.m.counts["stalls"] += 1
            t = end
        self.order[lba] = None
        return self._dram_write(t, lba)


class SimCoActive(PolicyBase):
    """Cold/hot separation + proactive idle eviction (Sun et al. [61])."""

    def __init__(self, cost, media, n_slots, idle_gap: float = 5.0) -> None:
        super().__init__(cost, media, n_slots)
        self.heat: dict[int, int] = defaultdict(int)
        self.clean: dict[int, float] = {}
        self.idle_gap = idle_gap
        self.last_io = 0.0
        self.sep_cost = 0.25

    def write(self, t: float, lba: int) -> float:
        t = max(t, self.drain_until)
        if t - self.last_io > self.idle_gap and self.dirty:
            # proactive eviction filled the idle window (background)
            end = self.last_io + self.idle_gap
            for x in sorted(self.dirty, key=lambda v: self.heat[v]):
                nxt = self.media.write(end, self.cost.btt_write())
                if nxt > t:
                    break
                end = nxt
                self.dirty.discard(x)
                self.clean[x] = end
                self.m.counts["proactive"] += 1
        self.last_io = t
        self.heat[lba] += 1
        t += self.sep_cost
        self.m.breakdown["cache_metadata"] += self.sep_cost
        if lba in self.resident:
            self.clean.pop(lba, None)
            return self._dram_write(t, lba)
        if self.full():
            if self.clean:
                victim = min(self.clean, key=self.clean.get)
                self.clean.pop(victim, None)
                self.resident.pop(victim, None)
            else:
                victim = min(self.dirty, key=lambda v: self.heat[v])
                self.dirty.discard(victim)
                self.resident.pop(victim, None)
                end = self._pmem_write(t, "cache_eviction_and_write")
                self.m.counts["stalls"] += 1
                t = end
        return self._dram_write(t, lba)

    def flush(self, t: float, sync: bool) -> float:
        """Unlike a plain drain, Co-Active keeps flushed blocks cached on
        the *clean* list (its drop-clean fast path) — plus expensive list
        surgery (the paper measures 1.9x PMBD/LRU flush time)."""
        t0 = t
        t = t + 0.02 * len(self.dirty)          # list surgery
        end = t
        for lba in list(self.dirty):
            end = self.media.write(end, self.cost.btt_write())
            self.clean[lba] = end
        self.m.counts["flush_blocks"] += len(self.dirty)
        self.dirty.clear()
        self.drain_until = max(self.drain_until, end)
        self.m.breakdown["cache_flush"] += end - t0
        return end if sync else t0


class SimCaiti(PolicyBase):
    """Eager eviction through a background worker pool + conditional
    bypass.  Slot lifecycle: occupied at DRAM write, freed when the worker's
    BTT write completes (Free→Pending→Valid→Evicting→Free)."""

    def __init__(self, cost, media, n_slots, n_workers: int = 8,
                 eager: bool = True, bypass: bool = True,
                 workers: list | None = None, global_full=None,
                 evict_notify=None) -> None:
        super().__init__(cost, media, n_slots)
        self.eager = eager
        self.bypass = bypass
        # ``workers`` shares one eviction-core pool across volume shards;
        # a shared pool is drained congestion-aware (earliest-free core)
        # instead of round-robin.
        self.shared_pool = workers is not None
        self.workers = workers if workers is not None \
            else [Bank() for _ in range(n_workers)]
        self.global_full = global_full     # volume aggregate watermark hook
        self.evict_notify = evict_notify   # read-tier writeback population
        self._rr = 0
        self.freed: deque[tuple[float, int]] = deque()   # (free_t, lba)
        self.occupied = 0
        self.evict_fence = 0.0

    def _evict_bg(self, t_valid: float, lba: int) -> float:
        """Background write-back; returns slot-free time."""
        if self.shared_pool:
            w = min(self.workers, key=lambda b: b.free_at)
        else:
            self._rr = (self._rr + 1) % len(self.workers)
            w = self.workers[self._rr]
        start = max(t_valid, w.free_at)
        done = self.media.write(start + self.cost.meta,
                                self.cost.btt_write())
        w.free_at = done
        self.evict_fence = max(self.evict_fence, done)
        self.m.counts["bg_evictions"] += 1
        if self.evict_notify is not None:
            self.evict_notify(lba)         # block stays warm in the tier
        return done

    def _reclaim(self, t: float) -> None:
        while self.freed and self.freed[0][0] <= t:
            _, lba = self.freed.popleft()
            if self.resident.pop(lba, None) is not None:
                self.occupied -= 1

    def write(self, t: float, lba: int) -> float:
        self._reclaim(t)
        if lba in self.resident:
            end = self._dram_write(t, lba)
            if self.eager:
                self.dirty.discard(lba)
                self.freed.append((self._evict_bg(end, lba), lba))
            self.m.breakdown["wbq_enqueue"] += 0.05
            return end + 0.05
        locally_full = self.occupied >= self.n_slots
        if locally_full or (self.bypass and self.global_full is not None
                            and self.global_full()):
            if self.bypass:
                end = self.media.write(t + self.cost.meta,
                                       self.cost.btt_write())
                self.m.breakdown["conditional_bypass"] += end - t
                self.m.counts["bypass"] += 1
                return end
            # w/o BP: wait for the oldest in-flight eviction
            if self.freed:
                free_t, victim = self.freed.popleft()
                if self.resident.pop(victim, None) is not None:
                    self.occupied -= 1
                self.m.breakdown["cache_eviction_and_write"] += \
                    max(0.0, free_t - t)
                self.m.counts["stalls"] += 1
                t = max(t, free_t)
            else:
                end = self._pmem_write(t, "cache_eviction_and_write")
                self.m.counts["stalls"] += 1
                return end
        self.occupied += 1
        end = self._dram_write(t, lba)
        self.m.breakdown["wbq_enqueue"] += 0.05
        if self.eager:
            self.dirty.discard(lba)
            self.freed.append((self._evict_bg(end, lba), lba))
        return end + 0.05

    def flush(self, t: float, sync: bool) -> float:
        """Eager eviction leaves (almost) nothing to drain: wait on the
        in-flight fence; drain lazy leftovers ('w/o EE' ablation)."""
        t0 = t
        end = max(t, self.evict_fence)
        if self.dirty:
            for _ in range(len(self.dirty)):
                end = self.media.write(end, self.cost.btt_write())
            self.m.counts["flush_blocks"] += len(self.dirty)
            self.dirty.clear()
            if not self.eager:
                self._reclaim(end)
                self.resident.clear()
                self.occupied = 0
        self._reclaim(end)
        self.m.breakdown["cache_flush"] += end - t0
        return end if sync else t


# --------------------------------------------------------------- factories
def make_sim_policy(policy: str, cost: CostModel, media: Media,
                    cache_slots: int, caiti_workers: int = 8):
    if policy == "btt":
        return SimBTTOnly(cost, media)
    if policy in ("raw", "dax"):
        return SimRawDev(cost, media, policy == "dax")
    if policy == "pmbd":
        return SimPMBD(cost, media, cache_slots)
    if policy == "pmbd70":
        return SimPMBD(cost, media, cache_slots, watermark=0.7, daemon=True)
    if policy == "lru":
        return SimLRU(cost, media, cache_slots)
    if policy == "coactive":
        return SimCoActive(cost, media, cache_slots)
    if policy == "caiti":
        return SimCaiti(cost, media, cache_slots, n_workers=caiti_workers)
    if policy == "caiti-noee":
        return SimCaiti(cost, media, cache_slots, n_workers=caiti_workers,
                        eager=False)
    if policy == "caiti-nobp":
        return SimCaiti(cost, media, cache_slots, n_workers=caiti_workers,
                        bypass=False)
    raise ValueError(policy)


def run_sim_workload(policy: str, *, n_ops: int, n_lbas: int,
                     cache_slots: int, iodepth: int = 32, jobs: int = 1,
                     fsync_every: int = 0, read_frac: float = 0.0,
                     flush_period_us: float = 5e4, seed: int = 0,
                     caiti_workers: int = 8, value_blocks: int = 1,
                     cost: CostModel | None = None,
                     lba_stream=None) -> SimMetrics:
    """Closed-loop fio-style workload in virtual time.

    Each *job* is a serial submitting core with ``iodepth`` outstanding
    requests (arrival of request i = completion of request i-iodepth).
    ``value_blocks`` writes that many consecutive blocks per request
    (LevelDB-style bulky I/O).  ``lba_stream`` overrides the uniform
    address pattern with a custom iterator (YCSB distributions).

    ``flush_period_us`` is the ext4 journal tick.  The paper's 5 s applies
    to its 64 GB / 30 min runs; benchmark volumes here are ~300x smaller,
    so the default tick is scaled to 50 ms to preserve the
    flushes-per-byte-written ratio (stated next to every table).
    """
    cost = cost or CostModel()
    media = Media(cost)
    dev = make_sim_policy(policy, cost, media, cache_slots, caiti_workers)
    rng = np.random.default_rng(seed)
    if lba_stream is None:
        lbas = rng.integers(0, max(1, n_lbas - value_blocks), size=n_ops)
    else:
        lbas = np.fromiter(itertools.islice(lba_stream, n_ops),
                           dtype=np.int64, count=n_ops)
    is_read = (rng.random(n_ops) < read_frac) if read_frac else None
    stack = cost.bio_stack / max(1, min(iodepth, 16))

    # per-job serial cores, each with a closed-loop depth window
    per_job = n_ops // jobs
    next_tick = flush_period_us
    t_global_done = 0.0
    job_core_free = [0.0] * jobs
    completions: list[list] = [[] for _ in range(jobs)]
    idx = 0
    # round-robin interleave jobs by processing in arrival order
    heads = [j * per_job for j in range(jobs)]
    ends = [(j + 1) * per_job for j in range(jobs)]
    # simple global-time loop: at each step pick the job whose next request
    # can start earliest (deterministic, work-conserving)
    while True:
        best_j, best_start = -1, float("inf")
        for j in range(jobs):
            if heads[j] >= ends[j]:
                continue
            k = heads[j] - j * per_job
            arrive = completions[j][k - iodepth] if k >= iodepth else 0.0
            start = max(arrive, job_core_free[j])
            if start < best_start:
                best_start, best_j = start, j
        if best_j < 0:
            break
        j = best_j
        i = heads[j]
        heads[j] += 1
        k = i - j * per_job
        arrive = completions[j][k - iodepth] if k >= iodepth else 0.0
        t = max(arrive, job_core_free[j])
        # ext4 journal tick (async PREFLUSH)
        while t >= next_tick:
            dev.flush(next_tick, sync=False)
            next_tick += flush_period_us
        t_proc = t + stack
        dev.m.breakdown["others"] += stack
        lba = int(lbas[i])
        if is_read is not None and is_read[i]:
            done = dev.read(t_proc, lba)
        else:
            done = dev.write(t_proc, lba)
            for extra in range(1, value_blocks):
                done = dev.write(done, lba + extra)
        if fsync_every and (k + 1) % fsync_every == 0:
            done = dev.flush(done, sync=True)
        job_core_free[j] = done
        completions[j].append(done)
        dev.m.lat(arrive, done)
        t_global_done = max(t_global_done, done)
    # terminal drain: every buffered block must reach the media before the
    # run "ends" (fio exit fsync) — keeps makespans bandwidth-conserving
    t_global_done = max(t_global_done,
                        dev.flush(t_global_done, sync=True))
    dev.m.counts["makespan_us"] = int(t_global_done)
    return dev.m


# --------------------------------------------------- chained-tx modeling
def chain_commit_steps(n_blocks: int, span: int) -> list[tuple]:
    """The ordered persistence steps of one chained-tx logical write, as
    ``repro_torch.volume.VolumeJournal.log_chain`` + the in-place phase issue
    them.  Each step is one atomic BTT block write:

      ("payload", link, i)   — journal payload block i of link ``link``
      ("header", link)       — a non-tail link header
      ("tail_header",)       — THE commit point (written last of all
                               headers; everything after it rolls forward,
                               everything before it leaves the old image)
      ("inplace", i)         — in-place data write of logical block i

    The threaded crash tests cross-validate the real volume against this
    model: for every injected crash point the surviving image must match
    :func:`chain_crash_outcome`.
    """
    assert n_blocks >= 1 and span >= 1
    links = [min(span, n_blocks - off) for off in range(0, n_blocks, span)]
    steps: list[tuple] = []
    for link, n in enumerate(links):
        steps.extend(("payload", link, i) for i in range(n))
    steps.extend(("header", link) for link in range(len(links) - 1))
    steps.append(("tail_header",))
    steps.extend(("inplace", i) for i in range(n_blocks))
    return steps


def chain_crash_outcome(n_blocks: int, span: int, crash_step: int) -> str:
    """Post-recovery image when the crash kills step ``crash_step``
    (0-based; that step and everything after it never execute):
    ``"old"`` before the tail header lands, ``"new"`` after — never a
    torn mix (the whole-object atomicity claim)."""
    steps = chain_commit_steps(n_blocks, span)
    tail_idx = steps.index(("tail_header",))
    return "new" if crash_step > tail_idx else "old"


# ---------------------------------------------------------------- volumes
class SimReadTier:
    """Virtual-time read tier: the REAL ``repro_torch.volume.ReadTier`` in
    object mode (keys only — block data is not simulated), so the
    simulator validates the exact CLOCK/second-chance policy the
    threaded implementation runs, not a reimplementation of it."""

    def __init__(self, n_slots: int) -> None:
        from repro_torch.volume.read_tier import ReadTier   # no import cycle at
        self._tier = ReadTier(block_size=None,        # call time
                              n_slots=max(1, n_slots))

    def hit(self, key) -> bool:
        return self._tier.lookup(key) is not None

    def insert(self, key) -> None:
        self._tier.insert(key, True)

    def invalidate(self, key) -> None:
        self._tier.invalidate(key)

    def hit_rate(self) -> float:
        return self._tier.hit_rate()

    @property
    def hits(self) -> int:
        return self._tier.hits

    @property
    def misses(self) -> int:
        return self._tier.misses


def zipf_lba_stream(rng, n_ops: int, n_lbas: int,
                    theta: float = 0.99) -> np.ndarray:
    """YCSB-style bounded zipfian addresses: rank k drawn with probability
    proportional to 1/(k+1)^theta, ranks scattered over the LBA space by a
    fixed permutation so the hot set spreads across volume shards."""
    w = 1.0 / np.power(np.arange(1, n_lbas + 1, dtype=np.float64), theta)
    ranks = rng.choice(n_lbas, size=n_ops, p=w / w.sum())
    perm = np.random.default_rng(12345).permutation(n_lbas)
    return perm[ranks]


class SimVolume:
    """Virtual-time model of the striped multi-device volume.

    Each shard is a full device (its own interleaved DIMM set = ``Media``)
    fronted by the per-policy cache; caiti shards share ONE background
    eviction-core pool, drained congestion-aware (earliest-free core), and
    honor the volume's aggregate-staged watermark for global conditional
    bypass.  ``cache_slots`` and ``n_workers`` are VOLUME totals, so a
    1-shard and an N-shard volume stage the same bytes with the same
    eviction cores — what N buys is media parallelism and shorter
    per-shard queues, which is the paper's contended resource.

    The layered read path (PR 2) is modeled in virtual time:

      * ``tier_slots > 0`` adds a volume-wide clean DRAM read tier.  A
        tier hit costs ``meta + dram_copy_4k`` (a dict probe + one DRAM
        copy); misses fill the tier, writes invalidate, caiti eviction
        writebacks re-populate — the same protocol as the threaded tier;
      * volume *read misses go through the shard's Media banks*: PMem
        reads share the DIMMs with eviction/bypass write traffic, so a
        read-heavy tenant feels the background write pressure (van Renen
        et al.'s read-write interference).  Transit-cache hits stay
        DRAM-priced;
      * ``degraded_every = N`` fails primary-shard verification on every
        Nth backend read: the read pays a second, replica-shard media
        round trip (the degraded-read detour).
    """

    def __init__(self, policy: str, cost: CostModel, *, n_shards: int,
                 cache_slots: int, n_workers: int = 8,
                 stripe_blocks: int = 64, watermark: float = 1.0,
                 tier_slots: int = 0, degraded_every: int = 0,
                 commit_window_us: float = 0.0,
                 log_window_us: float = 0.0,
                 journal_span: int = 8,
                 aio_workers: int = 0,
                 slow_shard: int | None = None,
                 slow_factor: float = 25.0) -> None:
        self.policy = policy
        self.cost = cost
        self.n_shards = n_shards
        self.stripe_blocks = stripe_blocks
        self.medias = [Media(cost) for _ in range(n_shards)]
        # fail-slow injection: one shard's whole DIMM set limps at
        # slow_factor x service time (it never fails — the throughput
        # counters look healthy, only the tail collapses)
        self.slow_shard = slow_shard
        if slow_shard is not None:
            self.medias[slow_shard].scale = slow_factor
        self.read_tier = SimReadTier(tier_slots) if tier_slots > 0 else None
        self.degraded_every = degraded_every
        self._backend_reads = 0
        self.vcounts: dict = defaultdict(int)
        # group commit: fsync checkpoints serialize on the commit lock
        # (one drain + one superblock header write per shard per commit);
        # with a window > 0 concurrent fsyncs coalesce behind a leader
        self.commit_window_us = commit_window_us
        self._commit_lock = Bank()             # the volume _txlock
        self._gc_start: float | None = None    # leader's scheduled start
        self._gc_done = 0.0
        # batched log pipeline: chained-tx log() calls serialize on the
        # same volume tx lock; with log_window_us > 0 concurrent calls
        # coalesce into one slot-shard pass behind a leader
        self.log_window_us = log_window_us
        self.journal_span = journal_span
        self._log_lock = Bank()
        self._lb_start: float | None = None    # leader's scheduled start
        self._lb_done = 0.0
        # async frontend (SimVolume.submit/poll): engine dispatch cores
        # modeled as serial servers — a submitted op runs on the
        # earliest-free core instead of occupying the submitting core
        self._aio_cores = [Bank() for _ in range(aio_workers)]
        self._aio_next = itertools.count(1)
        self._aio_open: dict[int, float] = {}   # ticket -> completion time
        slots_per = max(1, cache_slots // n_shards)
        self._total_slots = slots_per * n_shards
        self._watermark_slots = watermark * self._total_slots
        self._use_watermark = policy.startswith("caiti") and watermark < 1.0
        # control-plane surface: the hedge trigger the autotune workload
        # reads (mirrors cfg.hedge_delay_us on the threaded volume)
        self.hedge_delay_us = 1000.0
        if policy.startswith("caiti"):
            pool = [Bank() for _ in range(n_workers)]
            self.shards = [
                SimCaiti(cost, self.medias[i], slots_per,
                         eager=(policy != "caiti-noee"),
                         bypass=(policy != "caiti-nobp"),
                         workers=pool,
                         global_full=(self._over_watermark
                                      if self._use_watermark else None),
                         evict_notify=(self._make_evict_notify(i)
                                       if self.read_tier is not None
                                       else None))
                for i in range(n_shards)
            ]
        else:
            self.shards = [make_sim_policy(policy, cost, self.medias[i],
                                           slots_per)
                           for i in range(n_shards)]

    def _make_evict_notify(self, shard: int):
        return lambda local: self.read_tier.insert((shard, local))

    def _over_watermark(self) -> bool:
        staged = sum(s.occupied for s in self.shards)
        return staged >= self._watermark_slots

    def _map(self, lba: int) -> tuple[int, int]:
        st, within = divmod(lba, self.stripe_blocks)
        row, shard = divmod(st, self.n_shards)
        return shard, row * self.stripe_blocks + within

    def write(self, t: float, lba: int) -> float:
        shard, local = self._map(lba)
        if self.read_tier is not None:
            self.read_tier.invalidate((shard, local))
        return self.shards[shard].write(t, local)

    def read(self, t: float, lba: int) -> float:
        return self.read_ex(t, lba)[0]

    def read_ex(self, t: float, lba: int) -> tuple[float, str]:
        """(completion time, serving tier) — 'transit' | 'tier' |
        'backend'; the workload loop prices tier-aware WFQ charges with
        the source, like the threaded ``CaitiCache.read_ex``."""
        shard, local = self._map(lba)
        s = self.shards[shard]
        if local in s.resident:                  # staged write: DRAM hit
            return s.read(t, local), "transit"
        key = (shard, local)
        if self.read_tier is not None and self.read_tier.hit(key):
            self.vcounts["tier_hits"] += 1
            return t + self.cost.meta + self.cost.dram_copy_4k, "tier"
        # backend read: contends for the shard's DIMM banks with the
        # eviction/bypass write traffic
        self.vcounts["read_misses"] += 1
        end = self.medias[shard].write(t, self.cost.btt_read())
        if self.read_tier is not None:
            self.read_tier.insert(key)
        self._backend_reads += 1
        if self.degraded_every and \
                self._backend_reads % self.degraded_every == 0:
            # primary verification failed: replica round trip on its shard
            self.vcounts["degraded_reads"] += 1
            replica_shard = (shard + 1) % self.n_shards
            end = self.medias[replica_shard].write(
                end + self.cost.meta, self.cost.btt_read())
        return end, "backend"

    # ------------------------------------------------------ hedged reads
    def read_replica(self, t: float, lba: int, replica: int = 1) -> float:
        """Backend read of ``lba``'s replica copy on the rotated shard —
        the hedge leg.  No tier interaction: the hedge goes straight to
        the replica's media banks (the threaded engine submits the hedge
        ticket without ``out=`` for the same reason)."""
        shard, _local = self._map(lba)
        rshard = (shard + replica) % self.n_shards
        self.vcounts["replica_reads"] += 1
        return self.medias[rshard].write(t, self.cost.btt_read())

    def hedged_read(self, t: float, lba: int,
                    delay_us: float) -> tuple[float, str]:
        """Virtual-time hedged read, mirroring the threaded
        ``StripedVolume.hedged_read`` counter semantics exactly: the
        primary leg is issued at ``t``; if it has not completed within
        ``delay_us`` the replica leg fires at ``t + delay_us`` and the
        FIRST completion is served.  A hedge retires as ``hedges_won``
        iff its result is served, else ``hedges_cancelled`` — so
        ``hedges_fired == hedges_won + hedges_cancelled`` holds here the
        same way ``Metrics.tail_path()`` asserts it.  The loser's media
        time is NOT clawed back: cancellation frees the caller, not bank
        time already scheduled (matching the engine, where a discarded
        in-flight read still drains on its worker)."""
        end_p, _src = self.read_ex(t, lba)
        if end_p - t <= delay_us:
            return end_p, "primary"          # fast path: no hedge fired
        self.vcounts["hedges_fired"] += 1
        end_h = self.read_replica(t + delay_us, lba)
        if end_h < end_p:
            self.vcounts["hedges_won"] += 1
            return end_h, "hedge"
        self.vcounts["hedges_cancelled"] += 1
        return end_p, "primary"

    # ------------------------------------------------------ batched log
    def _issue_log_writes(self, start: float, n_writes: int) -> float:
        """Issue one chain's slot-shard writes AT ``start`` (no cross-
        write ordering): they queue on the striped shard DIMM banks and
        overlap — the batch-mode issue pattern."""
        end = start
        for k in range(n_writes):
            end = max(end, self.medias[k % self.n_shards].write(
                start, self.cost.btt_write()))
        return end

    def log(self, t: float, n_blocks: int) -> float:
        """One chained-tx logged write of ``n_blocks`` payload blocks
        (``journal_span`` blocks per link; writes = payloads + one header
        per link, the last being the tail).

        Per-call (``log_window_us == 0``): the chain's slot-shard writes
        are strictly ordered (headers after payloads, tail last) and the
        volume tx lock serializes callers — every journal block write
        waits out the previous one, the paper's on-demand small-write
        stall.  Batched: callers coalescing into a leader's batch share
        ONE tx-lock pass; within the batch, member chains have no
        cross-ordering until the shared tail pass, so their writes fan
        out across the striped shard DIMM banks in parallel, plus one
        tail-fence write per batch.  (Like ``fsync``'s group-commit
        model, a follower simulated later but inside the window rides
        the leader's batch — slightly optimistic for followers; the
        per-call baseline has no such slack, so the contrast is an upper
        bound well clear of the 1.3x acceptance bar.)"""
        self.vcounts["log_calls"] += 1
        links = -(-n_blocks // self.journal_span)
        self.vcounts["log_links"] += links
        writes = n_blocks + links            # payloads + headers (tail incl)
        if self.log_window_us <= 0:
            self.vcounts["log_batches"] += 1
            start = max(t, self._log_lock.free_at)
            end = start
            for k in range(writes):          # strictly ordered pass
                end = self.medias[k % self.n_shards].write(
                    end, self.cost.btt_write())
            self._log_lock.free_at = end
            return end
        if self._lb_start is not None and t <= self._lb_start:
            # coalesce: ride the gathering batch
            self.vcounts["log_coalesced"] += 1
            end = self._issue_log_writes(self._lb_start, writes)
            self._lb_done = max(self._lb_done, end)
            return self._lb_done
        # lead a new batch, gathering until t + window
        self.vcounts["log_batches"] += 1
        self._lb_start = t + self.log_window_us
        start = max(self._lb_start, self._log_lock.free_at)
        end = self._issue_log_writes(start, writes)
        end = self.medias[0].write(end, self.cost.btt_write())  # tail fence
        self._log_lock.free_at = end
        self._lb_done = end
        return end

    def flush(self, t: float, sync: bool) -> float:
        return max(s.flush(t, sync) for s in self.shards)

    def _commit(self, t: float) -> float:
        """One full checkpoint: serialize on the commit lock, drain every
        shard, then one applied-mark superblock header write per shard
        (the fsync round trip group commit amortizes)."""
        start = max(t, self._commit_lock.free_at)
        end = self.flush(start, sync=True)
        for m in self.medias:
            end = max(end, m.write(end, self.cost.btt_write()))
        self._commit_lock.free_at = end
        self.vcounts["commits"] += 1
        return end

    def fsync(self, t: float) -> float:
        """fsync with optional group commit: a caller arriving while a
        commit is still gathering (scheduled to start at ``_gc_start``)
        coalesces onto it; otherwise it leads a new commit that starts
        ``commit_window_us`` later to gather followers.

        Modeling note: the leader's drain is computed eagerly at its own
        call, so a follower whose write is *simulated later* (but with
        virtual time inside the window) rides the commit without adding
        to its drain — slightly optimistic for followers; their staged
        blocks drain at the next commit instead.  The per-call baseline
        has no such slack, so windowed-vs-per-call contrasts are upper
        bounds; the acceptance margin (>= 3x at window=20us vs the 1.3x
        bar) does not hinge on it."""
        self.vcounts["fsync_calls"] += 1
        if self.commit_window_us <= 0:
            return self._commit(t)
        if self._gc_start is not None and t <= self._gc_start:
            self.vcounts["fsync_coalesced"] += 1
            return self._gc_done
        self._gc_start = t + self.commit_window_us
        self._gc_done = self._commit(self._gc_start)
        return self._gc_done

    # --------------------------------------------------- async frontend
    def submit(self, t: float, op: str, lba: int = 0,
               n_blocks: int = 1) -> int:
        """Virtual-time model of ``StripedVolume.submit``: the op is
        dispatched to the earliest-free engine core (a serial server)
        instead of occupying the submitting core, so a tenant with
        queue depth > 1 overlaps its own ops across cores, shard DIMM
        banks and the background eviction pool.  Returns a ticket id;
        :meth:`poll` / :meth:`complete_time` surface the completion.
        Requires ``aio_workers > 0`` at construction."""
        assert self._aio_cores, "SimVolume built without aio_workers"
        core = min(self._aio_cores, key=lambda b: b.free_at)
        start = max(t, core.free_at)
        if op == "write":
            done = start
            for i in range(n_blocks):
                done = self.write(done, lba + i)
        elif op == "read":
            done = self.read(start, lba)
        elif op == "log":
            done = self.log(start, n_blocks)
            for i in range(n_blocks):
                done = self.write(done, lba + i)
        elif op == "fsync":
            done = self.fsync(start)
        else:
            raise ValueError(op)
        core.free_at = done
        tid = next(self._aio_next)
        self._aio_open[tid] = done
        self.vcounts["aio_submits"] += 1
        return tid

    def complete_time(self, tid: int) -> float:
        """Completion time of a still-open ticket (the driver's closed
        -loop gate; the ticket stays open until polled)."""
        return self._aio_open[tid]

    def poll(self, t: float) -> list[int]:
        """Tickets complete at time ``t``, oldest first (the shared
        completion ring); polled tickets are retired."""
        out = sorted((d, tid) for tid, d in self._aio_open.items()
                     if d <= t)
        for _d, tid in out:
            del self._aio_open[tid]
        return [tid for _d, tid in out]

    # ----------------------------------------------------- control plane
    def set_knobs(self, changes: dict) -> None:
        """Apply control-plane knob moves in virtual time — the sim-side
        mirror of ``StripedVolume._apply_knobs`` (windows stay µs here;
        the threaded volume converts to seconds).  ``scan_threshold``
        has no sim-side analogue (the sim tier has no scan detector) and
        is ignored."""
        if "commit_window_us" in changes:
            self.commit_window_us = float(changes["commit_window_us"])
        if "log_window_us" in changes:
            self.log_window_us = float(changes["log_window_us"])
        if "bypass_watermark" in changes:
            frac = float(changes["bypass_watermark"])
            self._watermark_slots = frac * self._total_slots
            if self.policy.startswith("caiti") and frac < 1.0 \
                    and not self._use_watermark:
                # the hook was not installed at construction (watermark
                # started at 1.0): retrofit it onto every caiti shard
                self._use_watermark = True
                for s in self.shards:
                    if hasattr(s, "global_full"):
                        s.global_full = self._over_watermark
        if "hedge_delay_us" in changes:
            self.hedge_delay_us = float(changes["hedge_delay_us"])

    def staged_frac(self) -> float:
        staged = sum(getattr(s, "occupied", 0) for s in self.shards)
        return staged / max(1, self._total_slots)

    def counts(self) -> dict:
        agg: dict = defaultdict(int)
        for s in self.shards:
            for k, v in s.m.counts.items():
                agg[k] += v
        for k, v in self.vcounts.items():
            agg[k] += v
        if self.read_tier is not None:
            agg["tier_misses"] += self.read_tier.misses
        return dict(agg)


def run_volume_sim_workload(policy: str, *, n_shards: int, n_lbas: int,
                            cache_slots: int, tenants: list[dict],
                            iodepth: int = 32, qdepth: int = 32,
                            n_workers: int = 8, stripe_blocks: int = 64,
                            watermark: float = 1.0, fsync_every: int = 0,
                            read_frac: float = 0.0,
                            flush_period_us: float = 5e4, seed: int = 0,
                            tier_slots: int = 0, degraded_every: int = 0,
                            lba_dist: str = "uniform",
                            zipf_theta: float = 0.99,
                            commit_window_us: float = 0.0,
                            log_blocks: int = 0,
                            log_window_us: float = 0.0,
                            tier_hit_cost_frac: float = 0.125,
                            cost: CostModel | None = None) -> dict:
    """Closed-loop multi-tenant fio workload against a striped volume.

    ``tenants`` — dicts with keys ``n_ops`` plus optional ``name``,
    ``jobs`` (submitting cores for this tenant, default 4), ``weight``
    (WFQ share, default 1.0) and ``rate_mbps`` (token-bucket cap, 0 =
    unlimited; MB/s == bytes/µs, so bucket math is exact in virtual time).

    Execution model matches ``run_sim_workload``: every job is a serial
    submitting core (inline bio execution), with an ``iodepth``-window
    closed loop feeding arrival times.  On top, the volume applies the QoS
    disciplines of ``repro_torch.volume.qos`` in virtual time: at most
    ``qdepth`` requests are dispatched-but-incomplete volume-wide, and
    when cores contend for a dispatch slot the smallest SFQ start tag
    ``S = max(V, F_tenant)`` wins, with ``F_tenant += bytes/weight``.
    Token buckets delay a job's arrival before tags are assigned, so a
    rate-capped tenant never accrues scheduling credit while throttled.

    Read-path knobs (PR 2): ``tier_slots`` enables the volume read tier,
    ``degraded_every`` injects a primary-verification failure on every
    Nth backend read, ``lba_dist='zipf'`` (with ``zipf_theta``) replaces
    the uniform address pattern with a YCSB-style skewed one.

    Commit-path knobs (PR 3): ``fsync_every`` routes through
    ``SimVolume.fsync`` — each commit serializes on the volume commit
    lock and pays one superblock header write per shard.
    ``commit_window_us > 0`` enables group commit: fsyncs arriving while
    a leader is gathering coalesce onto its single checkpoint, so N
    syncing tenants pay one header-write round trip instead of N
    (``counts['fsync_calls']`` vs ``counts['commits']``).

    Batched-log + fairness knobs (PR 4): ``log_blocks > 0`` turns every
    write op into a chained-tx logged write of that many blocks through
    ``SimVolume.log`` (then staged in place); ``log_window_us > 0``
    coalesces concurrent log calls into batched slot-shard passes.
    Tenant dicts accept a per-tenant ``read_frac`` (overriding the
    global one) so read-heavy and write-heavy tenants can share one
    volume, and SFQ finish tags are charged TIER-AWARE: an op's virtual
    time is its priced bytes — a DRAM-served read (transit or tier hit)
    costs ``tier_hit_cost_frac`` of its size, everything else full price
    — so the scheduler equalizes *cost* across mixed workloads
    (``per_tenant[..]['contended_charged_share']`` converges to the
    weight share).
    """
    cost = cost or CostModel()
    vol = SimVolume(policy, cost, n_shards=n_shards, cache_slots=cache_slots,
                    n_workers=n_workers, stripe_blocks=stripe_blocks,
                    watermark=watermark, tier_slots=tier_slots,
                    degraded_every=degraded_every,
                    commit_window_us=commit_window_us,
                    log_window_us=log_window_us)
    rng = np.random.default_rng(seed)
    nt = len(tenants)
    names = [t.get("name", f"t{j}") for j, t in enumerate(tenants)]
    weights = [float(t.get("weight", 1.0)) for t in tenants]
    rates = [float(t.get("rate_mbps", 0.0)) for t in tenants]   # bytes/us
    bursts = [float(t.get("burst_bytes", 64 << 10)) for t in tenants]
    rfracs = [float(t.get("read_frac", read_frac)) for t in tenants]
    bs = 4096.0
    stack = cost.bio_stack / max(1, min(iodepth, 16))

    # expand tenants into streams (one per submitting core)
    st_tenant: list[int] = []
    st_ops: list[np.ndarray] = []
    st_reads: list = []
    for j, t in enumerate(tenants):
        jobs = max(1, int(t.get("jobs", 4)))
        per = max(1, int(t["n_ops"]) // jobs)
        for _ in range(jobs):
            st_tenant.append(j)
            if lba_dist == "zipf":
                st_ops.append(zipf_lba_stream(rng, per, n_lbas, zipf_theta))
            else:
                st_ops.append(rng.integers(0, n_lbas, size=per))
            st_reads.append(rng.random(per) < rfracs[j] if rfracs[j]
                            else None)
    ns = len(st_tenant)
    heads = [0] * ns
    core_free = [0.0] * ns
    completions: list[list[float]] = [[] for _ in range(ns)]
    charged: list[list[tuple[float, float]]] = [[] for _ in range(nt)]
    metrics = [SimMetrics() for _ in range(nt)]
    finish = [0.0] * nt                  # SFQ per-tenant finish tags
    vtime = 0.0                          # virtual time = last start tag
    tb_tokens = list(bursts)
    tb_time = [0.0] * nt
    inflight: list[float] = []           # completion-time heap
    t_now = 0.0
    next_tick = flush_period_us
    t_done = 0.0

    def tb_ready(j: int, arrive: float) -> float:
        if rates[j] <= 0:
            return arrive
        avail = min(bursts[j], tb_tokens[j]
                    + (arrive - tb_time[j]) * rates[j])
        if avail >= bs:
            return arrive
        return tb_time[j] + (bs - tb_tokens[j]) / rates[j]

    def tb_take(j: int, start: float) -> None:
        if rates[j] <= 0:
            return
        tb_tokens[j] = min(bursts[j], tb_tokens[j]
                           + (start - tb_time[j]) * rates[j]) - bs
        tb_time[j] = start

    while True:
        # bounded volume window: wait for a slot before dispatching
        while len(inflight) >= qdepth:
            t_now = max(t_now, heapq.heappop(inflight))
        # candidate request per stream: (ready time, tenant SFQ tag)
        cands = []
        for s in range(ns):
            k = heads[s]
            if k >= len(st_ops[s]):
                continue
            j = st_tenant[s]
            arrive = completions[s][k - iodepth] if k >= iodepth else 0.0
            ready = max(tb_ready(j, arrive), core_free[s])
            s_tag = max(vtime, finish[j])
            cands.append((ready, s_tag, s, arrive))
        if not cands:
            break
        elig = [c for c in cands if c[0] <= t_now + 1e-9]
        if not elig:
            t_now = min(c[0] for c in cands)
            elig = [c for c in cands if c[0] <= t_now + 1e-9]
        ready, s_tag, s, arrive = min(elig, key=lambda c: (c[1], c[0], c[2]))
        j = st_tenant[s]
        heads[s] += 1
        vtime = max(vtime, s_tag)
        start = max(t_now, ready)
        tb_take(j, start)
        while start >= next_tick:          # ext4 journal tick
            vol.flush(next_tick, sync=False)
            next_tick += flush_period_us
        i = heads[s] - 1
        lba = int(st_ops[s][i])
        t_proc = start + stack
        metrics[j].breakdown["others"] += stack
        if st_reads[s] is not None and st_reads[s][i]:
            done, source = vol.read_ex(t_proc, lba)
            # tier-aware virtual time: a DRAM-served read is priced at
            # the admission layer's fraction of a PMem round trip
            op_cost = bs * (tier_hit_cost_frac if source != "backend"
                            else 1.0)
        elif log_blocks > 0:
            # chained-tx logged write: journal pass first (the commit
            # point), then the payload stages in place
            done = vol.log(t_proc, log_blocks)
            for k in range(log_blocks):
                done = vol.write(done, lba + k)
            op_cost = bs * log_blocks
        else:
            done = vol.write(t_proc, lba)
            op_cost = bs
        # SFQ: the tag was assigned pre-dispatch; the finish tag advances
        # by the op's PRICED bytes (dispatch is serialized, so the next
        # candidate scan always sees the settled tag)
        finish[j] = s_tag + op_cost / weights[j]
        charged[j].append((done, op_cost))
        if fsync_every and (i + 1) % fsync_every == 0:
            done = vol.fsync(done)
        heapq.heappush(inflight, done)
        completions[s].append(done)
        core_free[s] = done              # inline bio: core busy to completion
        metrics[j].lat(arrive, done)
        t_now = start
        t_done = max(t_done, done)

    t_done = max(t_done, vol.flush(t_done, sync=True))   # exit fsync
    counts = vol.counts()
    counts["makespan_us"] = int(t_done)
    writes = sum(len(ops) for ops in st_ops)
    per_tenant = {}
    spans = [0.0] * nt
    done_ops = [0] * nt
    for s in range(ns):
        j = st_tenant[s]
        done_ops[j] += len(completions[s])
        if completions[s]:
            spans[j] = max(spans[j], completions[s][-1])
    # fair-share window: while EVERY tenant still has work, throughput
    # must split by weight; after the fastest stream drains the remaining
    # tenants legitimately speed up, so whole-span ratios understate QoS
    t_contended = min((s for s in spans if s > 0), default=0.0)
    # charged virtual bytes inside the contended window: while every
    # tenant still has work, the SFQ discipline equalizes PRICED service
    # per weight — the fairness claim for mixed read/write tenants
    c_charged = [sum(c for d, c in charged[j] if d <= t_contended + 1e-9)
                 for j in range(nt)]
    tot_charged = sum(c_charged) or 1.0
    tot_weight = sum(weights) or 1.0
    for j in range(nt):
        c_ops = sum(1 for s in range(ns) if st_tenant[s] == j
                    for c in completions[s] if c <= t_contended + 1e-9)
        per_tenant[names[j]] = {
            "ops": done_ops[j],
            # a tenant's throughput is over ITS OWN stream's span (closed
            # loop: a favored tenant finishes its ops sooner, not "more")
            "mb_s": done_ops[j] * bs / max(spans[j], 1e-9),  # B/us == MB/s
            "span_us": spans[j],
            "contended_mb_s": c_ops * bs / max(t_contended, 1e-9),
            "charged_vbytes": sum(c for _, c in charged[j]),
            "contended_charged_share": c_charged[j] / tot_charged,
            "weight_share": weights[j] / tot_weight,
            "mean_us": metrics[j].mean(),
            "p9999_us": metrics[j].pct(99.99),
            "weight": weights[j],
            "rate_mbps": rates[j],
        }
    return {
        "policy": policy,
        "n_shards": n_shards,
        "makespan_us": t_done,
        "agg_mb_s": writes * bs / max(t_done, 1e-9),
        "bypass_rate": counts.get("bypass", 0) / max(1, writes),
        "tier_hit_rate": (vol.read_tier.hit_rate()
                          if vol.read_tier is not None else 0.0),
        "degraded_reads": counts.get("degraded_reads", 0),
        "counts": counts,
        "per_tenant": per_tenant,
    }


def run_autotune_sim_workload(policy: str = "caiti", *, phases: list[dict],
                              n_shards: int = 4, n_lbas: int = 1 << 16,
                              cache_slots: int = 4096, n_workers: int = 8,
                              iodepth: int = 8, stripe_blocks: int = 64,
                              watermark: float = 0.9, tier_slots: int = 0,
                              autotune=None,
                              control_every_us: float = 2000.0,
                              commit_window_us: float = 0.0,
                              log_window_us: float = 0.0,
                              journal_span: int = 8, seed: int = 0,
                              cost: CostModel | None = None) -> dict:
    """Phase-change trace against one :class:`SimVolume`, with an
    optional live control plane — the tuned-vs-frozen acceptance driver
    for ``benchmarks/scenarios.py``.

    ``phases`` run SEQUENTIALLY in virtual time over the same volume
    (so cache/tier state carries across the change — the whole point of
    a phase-change trace).  Each phase dict:

      ``name``      phase label (per-phase result key)
      ``tenants``   list of dicts: ``n_ops`` plus optional ``name``,
                    ``jobs`` (streams, default 2), ``read_frac``,
                    ``fsync_every`` (fsync per N stream ops, 0 = never),
                    ``log_blocks`` (writes become chained-tx logged
                    writes of that many blocks), ``think_us`` (per-op
                    idle after completion — the diurnal lull knob)
      ``lba_dist``  'uniform' | 'zipf' | 'seq' (per-stream sequential
                    runs — the ckpt-restore/backup scan shape)

    ``autotune`` is a REAL :class:`repro_torch.volume.autotune.Controller`
    (the sim validates the actual policy object, same idiom as
    ``SimReadTier``): every ``control_every_us`` of virtual time the
    driver computes one signal window from the volume's counter deltas
    and applies whatever knob moves the controller votes through
    (:meth:`SimVolume.set_knobs`).  ``autotune=None`` is the frozen
    baseline: knobs stay at their configured values for the whole
    trace.  Returns per-phase and whole-trace throughput/latency plus
    the knob trace (every applied move with its virtual timestamp) so
    tests can assert clamp safety and benches can plot convergence.
    """
    cost = cost or CostModel()
    vol = SimVolume(policy, cost, n_shards=n_shards,
                    cache_slots=cache_slots, n_workers=n_workers,
                    stripe_blocks=stripe_blocks, watermark=watermark,
                    tier_slots=tier_slots,
                    commit_window_us=commit_window_us,
                    log_window_us=log_window_us,
                    journal_span=journal_span)
    if autotune is not None:
        autotune.bind({"commit_window_us": commit_window_us,
                       "log_window_us": log_window_us,
                       "bypass_watermark": watermark})
    rng = np.random.default_rng(seed)
    bs = 4096.0
    stack = cost.bio_stack / max(1, min(iodepth, 16))
    knob_trace: list[tuple[float, dict]] = []
    per_phase: dict[str, dict] = {}
    all_lats: list[float] = []
    t_phase = 0.0
    next_ctl = control_every_us
    prev_counts: dict = {}
    win_ops = 0
    win_reads = 0
    win_writes = 0
    win_tenant_lats: dict[str, list] = {}

    def control_tick(t: float) -> None:
        nonlocal prev_counts, win_ops, win_reads, win_writes
        cur = vol.counts()
        d = {k: cur.get(k, 0) - prev_counts.get(k, 0)
             for k in set(cur) | set(prev_counts)}
        prev_counts = cur
        ops = max(1, win_ops)
        fsyncs = d.get("fsync_calls", 0)
        logs = d.get("log_calls", 0)
        reads = max(1, win_reads)
        sig = {
            "ops": win_ops,
            "fsync_rate": fsyncs / ops,
            "coalesce_rate": (d.get("fsync_coalesced", 0) / fsyncs
                              if fsyncs else 0.0),
            "log_rate": logs / ops,
            "log_coalesce_rate": (d.get("log_coalesced", 0) / logs
                                  if logs else 0.0),
            "stall_rate": d.get("stalls", 0) / ops,
            "bypass_rate": (d.get("bypass", 0) / win_writes
                            if win_writes else 0.0),
            "staged_frac": vol.staged_frac(),
            "read_rate": win_reads / ops,
            "tier_hit_rate": ((d.get("tier_hits", 0)
                               + d.get("read_hits", 0)) / reads
                              if win_reads else 0.0),
            "scan_denial_rate": 0.0,
            "per_tenant_p99_us": {
                name: float(np.percentile(ls, 99.0))
                for name, ls in win_tenant_lats.items() if ls},
        }
        changes = autotune.observe(sig)
        if changes:
            vol.set_knobs(changes)
            knob_trace.append((t, dict(changes)))
        win_ops = win_reads = win_writes = 0
        win_tenant_lats.clear()

    for phase in phases:
        pname = phase.get("name", f"phase{len(per_phase)}")
        tenants = phase["tenants"]
        lba_dist = phase.get("lba_dist", "uniform")
        theta = phase.get("zipf_theta", 0.99)
        st_tenant: list[str] = []
        st_ops: list[np.ndarray] = []
        st_reads: list = []
        st_fsync: list[int] = []
        st_log: list[int] = []
        st_think: list[float] = []
        for ten in tenants:
            jobs = max(1, int(ten.get("jobs", 2)))
            per = max(1, int(ten["n_ops"]) // jobs)
            rfrac = float(ten.get("read_frac", 0.0))
            for _ in range(jobs):
                st_tenant.append(ten.get("name", "t0"))
                if lba_dist == "zipf":
                    st_ops.append(zipf_lba_stream(rng, per, n_lbas, theta))
                elif lba_dist == "seq":
                    base = int(rng.integers(0, n_lbas))
                    st_ops.append((base + np.arange(per)) % n_lbas)
                else:
                    st_ops.append(rng.integers(0, n_lbas, size=per))
                st_reads.append(rng.random(per) < rfrac if rfrac else None)
                st_fsync.append(int(ten.get("fsync_every", 0)))
                st_log.append(int(ten.get("log_blocks", 0)))
                st_think.append(float(ten.get("think_us", 0.0)))
        ns = len(st_tenant)
        heads = [0] * ns
        core_free = [t_phase] * ns
        completions: list[list[float]] = [[] for _ in range(ns)]
        phase_lats: list[float] = []
        t_now = t_phase
        t_done = t_phase
        while True:
            cands = []
            for s in range(ns):
                k = heads[s]
                if k >= len(st_ops[s]):
                    continue
                arrive = completions[s][k - iodepth] if k >= iodepth \
                    else t_phase
                cands.append((max(arrive, core_free[s]), s, arrive))
            if not cands:
                break
            ready, s, arrive = min(cands)
            heads[s] += 1
            start = max(t_now, ready)
            t_now = start
            if autotune is not None:
                while start >= next_ctl:
                    control_tick(next_ctl)
                    next_ctl += control_every_us
            i = heads[s] - 1
            lba = int(st_ops[s][i])
            t_proc = start + stack
            if st_reads[s] is not None and st_reads[s][i]:
                done, _src = vol.read_ex(t_proc, lba)
                win_reads += 1
            elif st_log[s] > 0:
                done = vol.log(t_proc, st_log[s])
                for k in range(st_log[s]):
                    done = vol.write(done, (lba + k) % n_lbas)
                win_writes += 1
            else:
                done = vol.write(t_proc, lba)
                win_writes += 1
            if st_fsync[s] and (i + 1) % st_fsync[s] == 0:
                done = max(done, vol.fsync(done))
            win_ops += 1
            completions[s].append(done)
            core_free[s] = done + st_think[s]
            lat = done - arrive
            phase_lats.append(lat)
            all_lats.append(lat)
            win_tenant_lats.setdefault(st_tenant[s], []).append(lat)
            t_done = max(t_done, done)
        span = max(t_done - t_phase, 1e-9)
        per_phase[pname] = {
            "ops": len(phase_lats),
            "span_us": span,
            "ops_s": len(phase_lats) / span * 1e6,
            "p99_us": (float(np.percentile(phase_lats, 99.0))
                       if phase_lats else 0.0),
        }
        t_phase = t_done
    t_done = max(t_phase, vol.flush(t_phase, sync=True))
    counts = vol.counts()
    out = {
        "policy": policy,
        "makespan_us": t_done,
        "ops": len(all_lats),
        "ops_s": len(all_lats) / max(t_done, 1e-9) * 1e6,
        "mean_us": float(np.mean(all_lats)) if all_lats else 0.0,
        "p50_us": (float(np.percentile(all_lats, 50.0))
                   if all_lats else 0.0),
        "p99_us": (float(np.percentile(all_lats, 99.0))
                   if all_lats else 0.0),
        "per_phase": per_phase,
        "counts": counts,
        "knob_trace": knob_trace,
    }
    if autotune is not None:
        out["knob_final"] = autotune.values()
        out["autotune"] = autotune.stats()
    return out


def run_aio_sim_workload(policy: str, *, n_shards: int, n_lbas: int,
                         cache_slots: int, tenants: list[dict],
                         qdepth: int = 1, n_workers: int = 8,
                         aio_workers: int | None = None,
                         stripe_blocks: int = 64, op: str = "write",
                         log_blocks: int = 4, read_frac: float = 0.0,
                         watermark: float = 1.0, seed: int = 0,
                         copy_mode: str | None = None,
                         cost: CostModel | None = None) -> dict:
    """Closed-loop async-frontend workload against a striped volume:
    the queue-depth contrast for ``benchmarks/volume_bench.py --table
    aio``.

    Each tenant is ONE submitting core driving ``SimVolume.submit`` /
    ``poll`` with a bounded in-flight window of ``qdepth`` tickets
    (submission of ticket i gates on completion of ticket i-qdepth —
    the engine's per-tenant in-flight bound).  Two effects separate
    qd=1 from qd>=8, both of which the blocking frontend forfeits:

      * **submission batching** — the per-op syscall/block-layer cost
        (``bio_stack``) amortizes over ``min(qdepth, 16)`` like libaio
        io_submit (the paper's §5.2 'others' ≈54%% applies to depth-1);
      * **overlap** — a submitted op runs on an engine dispatch core
        (``aio_workers``, default ``2 x tenants``) while the submitter
        keeps submitting, so one tenant's ops spread over the shard
        DIMM banks and the eviction pool instead of serializing on its
        core.

    ``op='write'`` submits single-block staged writes; ``op='log'``
    submits ``log_blocks``-block chained-tx logged writes (journal pass
    + staging); ``read_frac`` mixes in reads.  Deterministic in virtual
    time, same cost model as every other table.

    ``copy_mode`` (PR 7, the zero-copy contrast; ``None`` keeps the
    legacy neutral submission cost so earlier tables are unchanged):

      * ``'copy'`` — every payload-carrying submit pays the defensive
        staging snapshot (``dram_copy_4k + meta`` per block: allocate +
        memcpy) UNDER THE ENGINE LOCK, exactly where
        ``AsyncIOEngine._snapshot_locked`` runs it.  The ring lock is a
        single serial server, so at high queue depth the snapshots
        serialize across every tenant and become the frontend
        bottleneck — the copy tax submission batching cannot amortize;
      * ``'zerocopy'`` — registered-buffer pinning: the submit pays one
        ``meta`` slot-bookkeeping charge under the same lock (pin the
        buffer to the ticket) and the payload crosses the engine by
        reference.
    """
    cost = cost or CostModel()
    nt = len(tenants)
    aio_workers = 2 * nt if aio_workers is None else aio_workers
    vol = SimVolume(policy, cost, n_shards=n_shards,
                    cache_slots=cache_slots, n_workers=n_workers,
                    stripe_blocks=stripe_blocks, watermark=watermark,
                    aio_workers=max(1, aio_workers))
    rng = np.random.default_rng(seed)
    names = [t.get("name", f"t{j}") for j, t in enumerate(tenants)]
    n_ops = [int(t["n_ops"]) for t in tenants]
    lbas = [rng.integers(0, max(1, n_lbas - log_blocks), size=n)
            for n in n_ops]
    rfracs = [float(t.get("read_frac", read_frac)) for t in tenants]
    is_read = [rng.random(n) < rf if rf else None
               for n, rf in zip(n_ops, rfracs)]
    bs = 4096.0
    stack = cost.bio_stack / max(1, min(qdepth, 16))
    assert copy_mode in (None, "copy", "zerocopy"), copy_mode
    blocks_per = log_blocks if op == "log" else 1
    if copy_mode == "copy":
        # allocate + memcpy per block, under the engine lock
        xfer = (cost.dram_copy_4k + cost.meta) * blocks_per
    elif copy_mode == "zerocopy":
        xfer = cost.meta                           # pin bookkeeping only
    else:
        xfer = 0.0
    ring_lock = Bank()               # the engine lock: one serial server

    heads = [0] * nt
    core_free = [0.0] * nt           # submitting core (busy per submit)
    inflight: list[list[float]] = [[] for _ in range(nt)]  # done times
    metrics = [SimMetrics() for _ in range(nt)]
    t_done = 0.0
    while True:
        # next submit per tenant: gated on its in-flight window
        best_j, best_start = -1, float("inf")
        for j in range(nt):
            if heads[j] >= n_ops[j]:
                continue
            k = heads[j]
            gate = inflight[j][k - qdepth] if k >= qdepth else 0.0
            start = max(gate, core_free[j])
            if start < best_start:
                best_start, best_j = start, j
        if best_j < 0:
            break
        j = best_j
        k = heads[j]
        heads[j] += 1
        arrive = inflight[j][k - qdepth] if k >= qdepth else 0.0
        t_sub = best_start + stack   # submission cost on the core
        if xfer:                     # snapshot/pin under the engine lock
            t_sub = ring_lock.serve(t_sub, xfer)
        core_free[j] = t_sub         # ... and the core is free again
        lba = int(lbas[j][k])
        if is_read[j] is not None and is_read[j][k]:
            tid = vol.submit(t_sub, "read", lba)
        elif op == "log":
            tid = vol.submit(t_sub, "log", lba, n_blocks=log_blocks)
        else:
            tid = vol.submit(t_sub, "write", lba)
        done = vol.complete_time(tid)
        vol.poll(done)               # retire (completion ring drained)
        inflight[j].append(done)
        metrics[j].lat(arrive, done)
        t_done = max(t_done, done)
    t_done = max(t_done, vol.flush(t_done, sync=True))   # exit fsync
    counts = vol.counts()
    counts["makespan_us"] = int(t_done)
    if copy_mode == "copy":
        counts["staging_copies"] = sum(n_ops)
    elif copy_mode == "zerocopy":
        counts["copies_avoided"] = sum(n_ops)
    total_ops = sum(n_ops)
    blocks_per_op = log_blocks if op == "log" else 1
    per_tenant = {}
    for j in range(nt):
        span = inflight[j][-1] if inflight[j] else 0.0
        per_tenant[names[j]] = {
            "ops": len(inflight[j]),
            "ops_s": len(inflight[j]) / max(span / 1e6, 1e-9),
            "mean_us": metrics[j].mean(),
            "p9999_us": metrics[j].pct(99.99),
        }
    return {
        "policy": policy,
        "n_shards": n_shards,
        "qdepth": qdepth,
        "makespan_us": t_done,
        "ops_s": total_ops / max(t_done / 1e6, 1e-9),
        "agg_mb_s": total_ops * blocks_per_op * bs / max(t_done, 1e-9),
        "counts": counts,
        "per_tenant": per_tenant,
    }


def run_hedge_sim_workload(policy: str = "btt", *, n_shards: int = 4,
                           n_lbas: int, n_clients: int = 4,
                           n_ops: int = 4000, hedge: bool = True,
                           hedge_delay_us: float | None = None,
                           slow_shard: int | None = 0,
                           slow_factor: float = 25.0,
                           stripe_blocks: int = 64,
                           cache_slots: int = 64, seed: int = 0,
                           cost: CostModel | None = None) -> dict:
    """Closed-loop read workload against a volume with ONE limping shard
    — the tail-latency contrast for ``benchmarks/volume_bench.py --table
    hedge``.

    ``slow_shard``'s media serves every request ``slow_factor`` x slower
    (fail-slow: nothing errors, nothing times out — mean throughput
    looks fine because only ``1/n_shards`` of uniform reads land there,
    but p99 collapses to the limping device's service time).  Each
    client is one serial core issuing uniform-random reads back to back;
    with ``hedge=True`` every read goes through
    :meth:`SimVolume.hedged_read` — the replica leg fires after
    ``hedge_delay_us`` of virtual time and the first completion wins.

    The default hedge delay is ``3 x btt_read()`` — a stand-in for the
    threaded scorer's healthy-cohort-median-p99 delay: comfortably above
    an unqueued healthy read, far below the limping shard's service
    time, so healthy-shard reads almost never hedge and limping-shard
    reads always escape.  Deterministic in virtual time; the hedged
    variant's p99 vs the unhedged one is the acceptance contrast (>= 2x
    at 25x limping, gated by ``check_floors.py``)."""
    cost = cost or CostModel()
    vol = SimVolume(policy, cost, n_shards=n_shards,
                    cache_slots=cache_slots, stripe_blocks=stripe_blocks,
                    slow_shard=slow_shard, slow_factor=slow_factor)
    delay = (3.0 * cost.btt_read() if hedge_delay_us is None
             else float(hedge_delay_us))
    rng = np.random.default_rng(seed)
    lbas = rng.integers(0, n_lbas, size=n_ops)
    t_free = [0.0] * max(1, n_clients)
    m = SimMetrics()
    slow_reads = 0
    stack = cost.bio_stack               # qdepth=1: full per-op stack cost
    for k in range(n_ops):
        j = min(range(len(t_free)), key=lambda i: t_free[i])
        arrive = t_free[j]
        lba = int(lbas[k])
        if slow_shard is not None and vol._map(lba)[0] == slow_shard:
            slow_reads += 1
        if hedge:
            done, _src = vol.hedged_read(arrive + stack, lba, delay)
        else:
            done = vol.read(arrive + stack, lba)
        m.lat(arrive, done)
        t_free[j] = done
    t_done = max(t_free)
    counts = vol.counts()
    counts["slow_shard_reads"] = slow_reads
    fired = counts.get("hedges_fired", 0)
    won = counts.get("hedges_won", 0)
    cancelled = counts.get("hedges_cancelled", 0)
    assert fired == won + cancelled, (fired, won, cancelled)
    return {
        "policy": policy,
        "n_shards": n_shards,
        "hedge": hedge,
        "hedge_delay_us": round(delay, 3),
        "slow_shard": slow_shard,
        "slow_factor": slow_factor if slow_shard is not None else 1.0,
        "n_ops": n_ops,
        "makespan_us": t_done,
        "ops_s": n_ops / max(t_done / 1e6, 1e-9),
        "mean_us": m.mean(),
        "p50_us": m.pct(50),
        "p99_us": m.pct(99),
        "p999_us": m.pct(99.9),
        "counts": counts,
    }


def run_transit_sim_workload(*, n_pages: int, page_kb: int = 16,
                             fused: bool = True, n_cores: int = 2,
                             cost: CostModel | None = None) -> dict:
    """Virtual-time model of the KV spill codec (the fused-transit
    contrast for ``benchmarks/volume_bench.py --table zerocopy``).

    Each page transits HBM -> host tier.  The THREE-PASS baseline walks
    the page once per stage, exactly like the pre-fusion code path:

      1. gather+quantize kernel pass   (``dram_copy_4k`` per 4 KB),
      2. host checksum walk over the packed bytes (1/4 size, int8),
      3. copy-out pass staging the payload for the eviction DMA.

    The FUSED path (``gather_quantize_crc``) does pack + checksum +
    copy-out in ONE traversal while the page is in VMEM.  Both variants
    then pay the same eviction-pool DMA (``pmem_write_4k`` on the
    interleaved banks, 1/4 size — int8) — fusion removes memory passes,
    not media time.  Codec passes run on ``n_cores`` eviction cores
    (earliest-free dispatch, same as the aio frontend)."""
    cost = cost or CostModel()
    media = Media(cost)
    cores = [Bank() for _ in range(max(1, n_cores))]
    per4k = page_kb / 4.0
    pass_us = cost.dram_copy_4k * per4k          # one full-page traversal
    packed4k = per4k / 4.0                       # int8 payload, 1/4 size
    if fused:
        codec_us = pass_us + cost.meta           # one pass + crc fold
        passes = 1
    else:
        # pack pass + checksum walk (packed size) + copy-out pass
        codec_us = pass_us + cost.dram_copy_4k * packed4k + pass_us
        passes = 3
    t_done = 0.0
    for _ in range(n_pages):
        core = min(cores, key=lambda b: b.free_at)
        t_codec = core.serve(core.free_at, codec_us)
        t_done = max(t_done, media.write(t_codec,
                                         cost.pmem_write_4k * packed4k))
    return {
        "fused": fused,
        "n_pages": n_pages,
        "page_kb": page_kb,
        "passes_per_page": passes,
        "makespan_us": t_done,
        "pages_s": n_pages / max(t_done / 1e6, 1e-9),
        "mb_s": n_pages * page_kb / 1024.0 / max(t_done / 1e6, 1e-9),
    }


def run_kv_paging_sim_workload(*, n_sessions: int, hbm_pages: int = 16,
                               host_pages: int = 32,
                               pages_per_session: int = 4,
                               page_blocks: int = 4,
                               shared_pages: int = 0,
                               tokens_per_turn: int = 16,
                               rounds: int = 2, decode_us: float = 40.0,
                               prefetch_depth: int = 4,
                               n_shards: int = 4, cache_slots: int = 512,
                               aio_workers: int = 4,
                               cost: CostModel | None = None) -> dict:
    """Virtual-time model of KV paging past DRAM (the sessions-sweep
    driver for ``benchmarks/serve_paged.py``).

    ``n_sessions`` chat sessions of ``pages_per_session`` KV pages each
    take ``rounds`` round-robin decode turns on ONE accelerator (a
    serial :class:`Bank`; a turn is ``tokens_per_turn x decode_us``).
    The HBM pool holds ``hbm_pages // pages_per_session`` resident
    sessions; activating a session past that evicts the least-recently
    decoded one through the tier walk the threaded cache runs:

      * HBM -> host: one fused codec pass per page (``dram_copy_4k`` per
        4 KB + ``meta``) on the eviction cores — off the decode path;
      * host overflow -> volume: the oldest host page spills as ONE
        chained ``log`` record of ``page_blocks`` blocks through
        ``SimVolume.submit`` (the async frontend: spill IO overlaps
        decode).  ``shared_pages`` of every session are a common prefix:
        content-addressed records mean the first spill writes and the
        rest are dedup refcount bumps — no IO;
      * volume -> HBM: restore reads one ticket per block.  With
        ``prefetch_depth > 0`` the reads for the next D scheduled
        sessions are issued when a turn STARTS decoding, so the volume
        round trip overlaps the running turn (decode-ahead); depth 0 is
        the synchronous contrast — activation stalls on the reads.

    Deterministic in virtual time; with ``n_sessions`` at the resident
    bound the tier machinery never engages and the run is pure decode
    (the degradation baseline)."""
    cost = cost or CostModel()
    assert pages_per_session >= 1 and shared_pages <= pages_per_session
    resident_cap = max(1, hbm_pages // pages_per_session)
    vol = SimVolume("caiti", cost, n_shards=n_shards,
                    cache_slots=cache_slots,
                    aio_workers=max(1, aio_workers))
    decode = Bank()                       # the accelerator, serial
    evict_cores = [Bank(), Bank()]        # fused-codec page-out cores
    page_us = cost.dram_copy_4k * page_blocks + cost.meta
    # page content keys: shared prefix pages dedup across sessions
    def key(s: int, p: int):
        return ("sh", p) if p < shared_pages else ("pv", s, p)

    loc: dict[tuple, str] = {}            # (s, p) -> hbm | host | vol
    host_fifo: list[tuple] = []           # (s, p) spill order
    resident: list[int] = []              # session ids, LRU order
    records: dict = {}    # key -> [lba, refs, done_t] live volume records
    free_lbas: list[int] = []
    next_lba = [0]
    pf_ready: dict[tuple, float] = {}     # (s, p) -> prefetched data time
    counts = defaultdict(int)

    def spill_page(t: float, s: int, p: int) -> None:
        k = key(s, p)
        rec = records.get(k)
        if rec is not None:
            rec[1] += 1
            counts["dedup_hits"] += 1
        else:
            lba = free_lbas.pop() if free_lbas else next_lba[0]
            if not free_lbas or lba == next_lba[0]:
                next_lba[0] = max(next_lba[0], lba + page_blocks)
            tid = vol.submit(t, "log", lba, n_blocks=page_blocks)
            records[k] = [lba, 1, vol.complete_time(tid)]
            vol.poll(vol.complete_time(tid))
            counts["spills"] += 1
            counts["spill_blocks"] += page_blocks
        loc[(s, p)] = "vol"

    def evict_session(t: float, victim: int) -> float:
        t_done = t
        for p in range(pages_per_session):
            if loc.get((victim, p)) != "hbm":
                continue
            core = min(evict_cores, key=lambda b: b.free_at)
            t_done = max(t_done, core.serve(max(t, core.free_at), page_us))
            loc[(victim, p)] = "host"
            host_fifo.append((victim, p))
            counts["hbm_evictions"] += 1
        while sum(1 for v in loc.values() if v == "host") > host_pages:
            s2, p2 = host_fifo.pop(0)
            if loc.get((s2, p2)) != "host":
                continue
            spill_page(t_done, s2, p2)
        return t_done

    def issue_reads(t: float, s: int) -> None:
        for p in range(pages_per_session):
            if loc.get((s, p)) != "vol" or (s, p) in pf_ready:
                continue
            k = key(s, p)
            lba = records[k][0]
            done = t
            for b in range(page_blocks):     # linked read chain
                tid = vol.submit(t, "read", lba + b)
                done = max(done, vol.complete_time(tid))
                vol.poll(vol.complete_time(tid))
            pf_ready[(s, p)] = done

    def activate(t: float, s: int, prefetched: bool) -> float:
        """Returns the time the session's pages are all HBM-resident."""
        if s in resident:
            resident.remove(s)
            resident.append(s)
            return t
        while len(resident) >= resident_cap:
            t = evict_session(t, resident.pop(0))
        ready = t
        if any(loc.get((s, p)) == "vol" for p in range(pages_per_session)):
            issue_reads(t, s)   # no-op for pages already in flight;
            for p in range(pages_per_session):  # sync pages start NOW
                if loc.get((s, p)) != "vol":
                    continue
                done = pf_ready.pop((s, p))
                if done <= t and prefetched:
                    counts["prefetch_hits"] += 1
                ready = max(ready, done)
                counts["restores_vol"] += 1
                k = key(s, p)
                rec = records[k]
                rec[1] -= 1
                if rec[1] == 0:
                    free_lbas.append(rec[0])
                    del records[k]
                loc[(s, p)] = "host"        # restored payload, unpack next
        for p in range(pages_per_session):
            where = loc.get((s, p))
            if where == "host":
                ready += page_us            # dequant pass on the way in
                counts["restores_host"] += 1
            loc[(s, p)] = "hbm"
        resident.append(s)
        return ready

    schedule = [s for _r in range(rounds) for s in range(n_sessions)]
    prefetched: set[int] = set()
    tokens = 0
    for i, s in enumerate(schedule):
        t0 = decode.free_at
        t_ready = activate(t0, s, s in prefetched)
        prefetched.discard(s)
        t_start = max(t_ready, decode.free_at)
        if prefetch_depth > 0:
            # decode-ahead: reads for the next D distinct sessions
            nxt = []
            for s2 in schedule[i + 1:]:
                if s2 not in nxt and s2 != s:
                    nxt.append(s2)
                if len(nxt) >= prefetch_depth:
                    break
            for s2 in nxt:
                if any(loc.get((s2, p)) == "vol"
                       for p in range(pages_per_session)):
                    issue_reads(t_start, s2)
                    prefetched.add(s2)
                    counts["prefetch_issued"] += 1
        decode.serve(t_start, tokens_per_turn * decode_us)
        tokens += tokens_per_turn
    counts["prefetch_wasted"] = len(pf_ready)   # issued, never consumed
    makespan = decode.free_at
    return {
        "n_sessions": n_sessions,
        "resident_cap": resident_cap,
        "rounds": rounds,
        "tokens": tokens,
        "makespan_us": makespan,
        "tokens_s": tokens / max(makespan / 1e6, 1e-9),
        "prefetch_depth": prefetch_depth,
        "shared_pages": shared_pages,
        **{k: int(counts[k]) for k in
           ("spills", "spill_blocks", "dedup_hits", "hbm_evictions",
            "restores_host", "restores_vol", "prefetch_issued",
            "prefetch_hits", "prefetch_wasted")},
        "live_records": len(records),
    }


# ---------------------------------------------------------------- cluster
class SimCluster:
    """Virtual-time model of the distributed cluster volume
    (``repro_torch.cluster``): ``n_nodes`` member :class:`SimVolume`\\ s, each
    behind a serial NIC :class:`Bank`, with chunk chains mapped by the
    REAL :class:`repro_torch.cluster.placement.PlacementPolicy` (imported at
    call time, like :class:`SimReadTier`) — the simulator exercises the
    exact placement the threaded cluster runs.

    Replication modes (the acceptance contrast):

      ``pipelined``  chain replication with cut-through forwarding: the
                     client uplinks the payload ONCE to the primary; hop
                     j starts receiving one block behind hop j-1, so K
                     transfers overlap to within a block and node writes
                     overlap upstream transfers.  Acks ripple tail to
                     head concurrently with upstream work — one final
                     ack latency reaches the client;
      ``serial``     client-fanout replication: the client sends the
                     payload to every replica itself (K uplinks
                     serialize on its NIC) and each replica acks
                     directly — the flat-replication baseline.

    NICs are serial servers, so concurrent tenants contend for node
    ingress exactly like submitting cores contend for shard DIMM banks.
    A node kill mid-workload drops it from every chain (writes fail over
    to the surviving members); :meth:`rereplicate` runs the regeneration
    storm — survivor media read, one-block transfer, target write per
    lost block — in virtual time, chosen by ``placement.replacement``.
    """

    def __init__(self, policy: str, cost: CostModel, *, n_nodes: int,
                 replication_k: int = 2, chunk_blocks: int = 64,
                 cache_slots: int = 4096, n_workers: int = 4,
                 n_shards: int = 2, stripe_blocks: int = 16,
                 racks: int = 2, placement: str = "spread",
                 net_latency_us: float = 5.0,
                 net_mb_s: float = 3000.0) -> None:
        from repro_torch.cluster.placement import (NodeInfo,   # no import cycle
                                             PlacementPolicy)  # at call time
        self.cost = cost
        self.vols = [SimVolume(policy, cost, n_shards=n_shards,
                               cache_slots=cache_slots, n_workers=n_workers,
                               stripe_blocks=stripe_blocks)
                     for _ in range(n_nodes)]
        self.nics = [Bank() for _ in range(n_nodes)]
        infos = [NodeInfo(f"node{i}", rack=i % max(1, racks))
                 for i in range(n_nodes)]
        self.place = PlacementPolicy(infos, k=replication_k,
                                     policy=placement)
        self.lat = net_latency_us
        self.bw = net_mb_s                 # MB/s == bytes/us (exact)
        self.chunk_blocks = chunk_blocks
        self.chains: dict[int, list[int]] = {}
        self.alive = [True] * n_nodes
        self._written: dict[int, set] = defaultdict(set)
        self.ccounts: dict = defaultdict(int)
        self.bs = 4096.0

    # -------------------------------------------------------------- mapping
    def _chain(self, chunk: int) -> list[int]:
        ch = self.chains.get(chunk)
        if ch is None:
            elig = [i for i in range(len(self.vols)) if self.alive[i]]
            ch = self.place.assign(chunk, self.chunk_blocks,
                                   eligible=elig or None)
            self.chains[chunk] = ch
        return ch

    def _span(self, nbytes: float) -> float:
        return nbytes / self.bw

    # ------------------------------------------------------------------ I/O
    def write(self, t: float, client_nic: Bank, lba: int, n_blocks: int,
              mode: str = "pipelined") -> float:
        """One replicated logical write of ``n_blocks`` consecutive
        blocks (must stay inside one chunk); returns the ack time at the
        client."""
        chunk = lba // self.chunk_blocks
        chain = [i for i in self._chain(chunk) if self.alive[i]]
        assert chain, "no live replica for chunk"
        nbytes = n_blocks * self.bs
        w = self._span(nbytes)             # full-payload transfer span
        b = self._span(self.bs)            # one-block span (cut-through)
        self.ccounts["cluster_writes"] += 1
        self.ccounts["net_bytes"] += int(nbytes) * len(chain)
        for i in range(n_blocks):
            self._written[chunk].add(lba + i)
        if mode == "pipelined":
            depart = client_nic.serve(t, w)            # ONE client uplink
            arr = self.nics[chain[0]].serve(depart - w + b + self.lat, w)
            done = 0.0
            for j, ni in enumerate(chain):
                if j > 0:                  # hop j trails hop j-1 by a block
                    arr = self.nics[ni].serve(arr - w + b + self.lat, w)
                end = arr
                for i in range(n_blocks):
                    end = self.vols[ni].write(end, lba + i)
                done = max(done, end)
            return done + self.lat         # tail ack ripples concurrently
        # serial: K uplinks on the client NIC, per-replica direct acks
        done = 0.0
        for ni in chain:
            depart = client_nic.serve(t, w)
            arr = self.nics[ni].serve(depart - w + b + self.lat, w)
            end = arr
            for i in range(n_blocks):
                end = self.vols[ni].write(end, lba + i)
            done = max(done, end + self.lat)
        return done

    def read(self, t: float, client_nic: Bank, lba: int) -> float:
        chain = [i for i in self._chain(lba // self.chunk_blocks)
                 if self.alive[i]]
        assert chain, "no live replica for chunk"
        ni = chain[0]
        end = self.vols[ni].read(t + self.lat, lba)
        self.ccounts["net_bytes"] += int(self.bs)
        return client_nic.serve(end + self.lat, self._span(self.bs))

    # ------------------------------------------------------------- failures
    def kill(self, node: int) -> None:
        self.alive[node] = False
        self.ccounts["nodes_killed"] += 1

    def rereplicate(self, t: float) -> float:
        """The regeneration storm after a death: every written chunk that
        lost a chain member is copied — survivor media read, one-block
        transfer, target write — onto ``placement.replacement``'s pick.
        Returns the storm's completion time."""
        end = t
        for chunk, chain in sorted(self.chains.items()):
            for dead in [i for i in chain if not self.alive[i]]:
                alive = [i for i in range(len(self.vols)) if self.alive[i]]
                target = self.place.replacement(chain, dead, alive)
                src = next((i for i in chain
                            if i != dead and self.alive[i]), None)
                if target is None or src is None:
                    self.ccounts["rereplication_unplaceable"] += 1
                    continue
                tt = t
                lbas = sorted(self._written.get(chunk, ()))
                for lba in lbas:
                    r = self.vols[src].read(tt, lba)
                    a = self.nics[target].serve(r + self.lat,
                                                self._span(self.bs))
                    tt = self.vols[target].write(a, lba)
                chain[chain.index(dead)] = target
                self.place.transfer(dead, target, len(lbas))
                self.ccounts["chunks_repaired"] += 1
                self.ccounts["rereplicated_blocks"] += len(lbas)
                self.ccounts["net_bytes"] += int(len(lbas) * self.bs)
                end = max(end, tt)
        return end

    def counts(self) -> dict:
        agg: dict = defaultdict(int)
        for v in self.vols:
            for k, x in v.counts().items():
                agg[k] += x
        for k, x in self.ccounts.items():
            agg[k] += x
        return dict(agg)


def run_cluster_sim_workload(policy: str = "btt", *, n_nodes: int = 4,
                             replication_k: int = 2, n_lbas: int,
                             chunk_blocks: int = 64,
                             cache_slots: int = 4096,
                             tenants: list[dict], n_blocks: int = 8,
                             qdepth: int = 4, mode: str = "pipelined",
                             placement: str = "spread", racks: int = 2,
                             net_latency_us: float = 5.0,
                             net_mb_s: float = 3000.0,
                             read_frac: float = 0.0,
                             kill_node: int | None = None,
                             kill_at_frac: float = 0.5,
                             n_workers: int = 4, n_shards: int = 2,
                             stripe_blocks: int = 16, seed: int = 0,
                             cost: CostModel | None = None) -> dict:
    """Closed-loop replicated-write workload against a
    :class:`SimCluster` — the ``--table cluster`` engine.

    Each tenant is one serial client core with its own NIC and a bounded
    window of ``qdepth`` outstanding replicated writes (submission of
    request i gates on completion of request i-qdepth).  Addresses are
    chunk-aligned groups of ``n_blocks`` so every logical write stays
    inside one chain — the whole-object-atomic envelope the threaded
    cluster enforces.

    ``mode`` selects the replication discipline (``pipelined`` chain vs
    ``serial`` client-fanout — see :class:`SimCluster`); the ops/s ratio
    between the two at 4 nodes / K=2 is the paper-style acceptance
    contrast (>= 1.5x).

    ``kill_node`` fail-stops that node once ``kill_at_frac`` of all ops
    have completed: in-flight and subsequent writes fail over to the
    surviving chain members, and the re-replication storm
    (:meth:`SimCluster.rereplicate`) runs to completion in virtual time
    — its span and block count are reported in ``counts``.
    """
    cost = cost or CostModel()
    cl = SimCluster(policy, cost, n_nodes=n_nodes,
                    replication_k=replication_k, chunk_blocks=chunk_blocks,
                    cache_slots=cache_slots, n_workers=n_workers,
                    n_shards=n_shards, stripe_blocks=stripe_blocks,
                    racks=racks, placement=placement,
                    net_latency_us=net_latency_us, net_mb_s=net_mb_s)
    rng = np.random.default_rng(seed)
    nt = len(tenants)
    names = [t.get("name", f"t{j}") for j, t in enumerate(tenants)]
    n_ops = [int(t["n_ops"]) for t in tenants]
    n_chunks = max(1, n_lbas // chunk_blocks)
    groups = max(1, chunk_blocks // n_blocks)
    lbas = [rng.integers(0, n_chunks, size=n) * chunk_blocks
            + rng.integers(0, groups, size=n) * n_blocks
            for n in n_ops]
    is_read = [rng.random(n) < read_frac if read_frac else None
               for n in n_ops]
    client_nics = [Bank() for _ in range(nt)]
    stack = cost.bio_stack / max(1, min(qdepth, 16))
    total = sum(n_ops)
    kill_at = int(total * kill_at_frac) if kill_node is not None else -1

    heads = [0] * nt
    core_free = [0.0] * nt
    inflight: list[list[float]] = [[] for _ in range(nt)]
    metrics = [SimMetrics() for _ in range(nt)]
    t_done, n_done = 0.0, 0
    storm_span = 0.0
    while True:
        best_j, best_start = -1, float("inf")
        for j in range(nt):
            if heads[j] >= n_ops[j]:
                continue
            k = heads[j]
            gate = inflight[j][k - qdepth] if k >= qdepth else 0.0
            start = max(gate, core_free[j])
            if start < best_start:
                best_start, best_j = start, j
        if best_j < 0:
            break
        j = best_j
        k = heads[j]
        heads[j] += 1
        arrive = inflight[j][k - qdepth] if k >= qdepth else 0.0
        lba = int(lbas[j][k])
        t_sub = best_start + stack       # submit cost on the client core;
        core_free[j] = t_sub             # the NIC serializes the uplinks
        if is_read[j] is not None and is_read[j][k]:
            done = cl.read(t_sub, client_nics[j], lba)
        else:
            done = cl.write(t_sub, client_nics[j], lba, n_blocks,
                            mode=mode)
        inflight[j].append(done)
        metrics[j].lat(arrive, done)
        t_done = max(t_done, done)
        n_done += 1
        if n_done == kill_at and cl.alive[kill_node]:
            cl.kill(kill_node)
            storm_end = cl.rereplicate(t_done)
            storm_span = storm_end - t_done
            t_done = max(t_done, storm_end)
    counts = cl.counts()
    counts["makespan_us"] = int(t_done)
    counts["storm_span_us"] = int(storm_span)
    per_tenant = {}
    for j in range(nt):
        span = inflight[j][-1] if inflight[j] else 0.0
        per_tenant[names[j]] = {
            "ops": len(inflight[j]),
            "ops_s": len(inflight[j]) / max(span / 1e6, 1e-9),
            "mean_us": metrics[j].mean(),
            "p9999_us": metrics[j].pct(99.99),
        }
    return {
        "policy": policy,
        "mode": mode,
        "n_nodes": n_nodes,
        "replication_k": replication_k,
        "placement": placement,
        "makespan_us": t_done,
        "ops_s": total / max(t_done / 1e6, 1e-9),
        "agg_mb_s": total * n_blocks * 4096.0 / max(t_done, 1e-9),
        "rack_diversity": (
            sum(cl.place.rack_diversity(c) for c in cl.chains.values())
            / max(1, len(cl.chains))),
        "balance": cl.place.balance(),
        "counts": counts,
        "per_tenant": per_tenant,
    }
