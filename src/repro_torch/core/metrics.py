"""Per-category time accounting used for the paper's Fig. 6 breakdown.

Categories follow the paper's naming exactly:
  cache_metadata        — set lookup / slot alloc / state transitions
  cache_write_only      — the DRAM memcpy into a slot (hit or free slot)
  cache_eviction_and_write — a *stalled* write: evict-on-critical-path + write
  conditional_bypass    — direct BTT write because cache is full
  wbq_enqueue           — putting the slot on the write-back queue
  cache_flush           — serving PREFLUSH/FUA/fsync drains
  others                — everything else on the critical path

Read-path counters (the layered read stack of PR 2) are plain events on
``count`` — ``read_path()`` summarizes where reads were served from:
  read_hits             — transit-cache (staged write) hits
  read_tier_hits        — clean DRAM read-tier hits
  read_tier_fills       — tier populations from a backend read miss
  read_misses           — full BTT/PMem round trips
  verify_failures       — primary copies failing crc verification
  degraded_reads        — reads served from a replica instead
  verify_races          — all copies agreed, only the ledger disagreed
                          (a mid-flight write, not corruption)
  unrecoverable_reads   — no copy matched the ledger (surfaced primary)
  resync_repairs        — divergent copies rewritten by the resyncer
  tier_fill_bypassed    — read-miss fills denied by the admission layer
                          (sequential-scan bypass: the scan must not
                          flush the tier's hot set)

Commit-path counters (the transactional write pipeline of PR 3, batched
log pipeline of PR 4) live on ``count`` as well — ``commit_path()``
summarizes them:
  chain_txs             — chained-journal links logged (whole-object
                          atomicity for >span logical writes)
  group_commits         — leader-executed fsync checkpoints
  group_commit_waiters  — fsync calls that coalesced onto a leader's
                          commit instead of paying their own drain +
                          superblock pass
  log_batches           — LogBatcher flushes (one _txlock acquisition +
                          one batched slot-shard journal pass each)
  log_batch_links       — chain links written through batched passes
  log_batch_coalesced   — log()/write_multi chains that rode another
                          caller's batch instead of paying their own pass

Per-tenant counters are bumped under ``"<event>::<tenant>"`` keys and
collected with :meth:`Metrics.per_tenant` — the volume records
``wfq_vbytes::<tenant>``, the tier-aware WFQ virtual time (priced bytes)
each tenant has been charged across reads, writes and batched journal
traffic.

Service-time EWMAs (fail-slow groundwork): :meth:`Metrics.observe`
tracks a per-key exponentially weighted moving average of service
nanoseconds (plus count and max) under ``svc::<where>`` keys — the
striped volume observes ``svc::shard<i>``, the async engine
``svc::aio::<op>``, the cluster layer ``svc::node<i>``.
:meth:`Metrics.per_node` collects them, and both the volume and cluster
``scrub`` outputs surface the table: a limping shard/node (fail-slow,
not fail-stop) shows up as one EWMA drifting away from its peers long
before any heartbeat trips.

Tail-latency layer (PR 8): :meth:`observe` additionally keeps a bounded
ring of recent raw samples per key, so :meth:`digest` can report real
p50/p99 latency percentiles (an EWMA hides a bimodal limping device —
the tail is the signal).  :class:`ShardScorer` turns a digest family
(``svc::shard*`` or ``svc::node*``) into a ``healthy``/``limping``/
``dead`` state per member, a p99-based hedge delay, and a steering
penalty multiplier; ``tail_path()`` summarizes the hedged-read counters
(``hedges_fired`` must equal ``hedges_won + hedges_cancelled`` — a
hedge loser is cancelled, never abandoned).
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager

CATEGORIES = (
    "cache_metadata",
    "cache_write_only",
    "cache_eviction_and_write",
    "conditional_bypass",
    "wbq_enqueue",
    "cache_flush",
    "others",
)

READ_COUNTERS = (
    "read_hits",
    "read_tier_hits",
    "read_tier_fills",
    "read_misses",
    "verify_failures",
    "degraded_reads",
    "verify_races",
    "unrecoverable_reads",
    "resync_repairs",
    "tier_fill_bypassed",
)

COMMIT_COUNTERS = (
    "chain_txs",
    "group_commits",
    "group_commit_waiters",
    "log_batches",
    "log_batch_links",
    "log_batch_coalesced",
)

# Zero-copy data plane counters (PR 7) — bumped by the async engine's
# registered-buffer pool / linked-SQE machinery and by the fused transit
# kernel's callers; ``zerocopy_path()`` summarizes them:
#   copies_avoided       — submits that pinned a registered buffer (or
#                          landed a read directly in one) instead of
#                          taking a staging snapshot
#   bytes_pinned         — payload bytes that crossed the engine pinned
#   staging_copies       — defensive snapshots (unregistered mutable
#                          payloads + copy-on-evict steals)
#   staging_copy_bytes   — bytes those snapshots copied
#   links_submitted      — linked-SQE tickets (chained to a parent)
#   link_cancelled       — dependents failed with ECANCELED by a parent
#   link_depth_max       — deepest chain seen
#   fused_kernel_passes  — fused transit-kernel launches (one VMEM pass
#                          doing gather/scatter + int8 codec + checksum)
#   fused_kernel_bytes   — packed payload bytes those passes moved
#   transit_crc_errors   — restore checksums that failed verification
ZEROCOPY_COUNTERS = (
    "copies_avoided",
    "bytes_pinned",
    "staging_copies",
    "staging_copy_bytes",
    "links_submitted",
    "link_cancelled",
    "link_depth_max",
    "fused_kernel_passes",
    "fused_kernel_bytes",
    "transit_crc_errors",
)


# Tail-latency path counters (PR 8) — bumped by the hedged-read and
# slow-path-steering machinery; ``tail_path()`` summarizes them:
#   hedges_fired         — backup reads launched after the hedge delay
#   hedges_won           — hedges that completed before the primary
#   hedges_cancelled     — hedge losers cancelled (primary won first)
#   primaries_cancelled  — primary losers cancelled because the hedge won
#   hedged_reads         — reads that armed a hedge timer (fired or not)
#   steered_evictions    — eviction-pool drains deferred off a limping shard
#   steered_charges      — WFQ admissions priced up on a limping shard
#   steered_placements   — chain placements that skipped a limping node
TAIL_COUNTERS = (
    "hedges_fired",
    "hedges_won",
    "hedges_cancelled",
    "primaries_cancelled",
    "hedged_reads",
    "steered_evictions",
    "steered_charges",
    "steered_placements",
)


# Control-plane counters (PR 9) — bumped by the self-tuning loop
# (``StripedVolume.autotune_step`` / ``ClusterVolume.autotune_step``);
# per-knob move counts ride the per-tenant convention as
# ``autotune_moves::<knob>``.  ``autotune_path()`` summarizes them:
#   autotune_ticks       — control ticks observed (signal windows)
#   autotune_moves       — knob moves actually applied (hysteresis and
#                          the clamps hold most ticks at zero moves)
AUTOTUNE_COUNTERS = (
    "autotune_ticks",
    "autotune_moves",
)


# KV-paging counters (PR 10) — bumped by the serve plane's volume-backed
# spill tier (``serve.kvpager.KVPager`` + ``PagedKVCache`` host-tier
# overflow); ``kv_paging_path()`` summarizes them:
#   kv_spills             — pages written to the volume (chained write_multi)
#   kv_spill_blocks       — volume blocks those spills occupied
#   kv_dedup_hits         — spills resolved by content hash to a live slot
#                           (prefix-shared pages: refcount bump, no write)
#   kv_spill_frees        — slots freed when the last reference released
#   kv_restores           — pages read back from the volume
#   kv_prefetch_issued    — decode-ahead reads submitted before activate()
#   kv_prefetch_hits      — restores served from a completed prefetch
#   kv_prefetch_wasted    — prefetched payloads dropped unconsumed
#   kv_restore_crc_errors — wire-checksum mismatches on restore (must be 0)
KV_PAGING_COUNTERS = (
    "kv_spills",
    "kv_spill_blocks",
    "kv_dedup_hits",
    "kv_spill_frees",
    "kv_restores",
    "kv_prefetch_issued",
    "kv_prefetch_hits",
    "kv_prefetch_wasted",
    "kv_restore_crc_errors",
)


#: EWMA smoothing for :meth:`Metrics.observe` — ~the last 10-ish
#: observations dominate, so a shard/node turning slow moves its average
#: within tens of ops instead of being diluted by history
EWMA_ALPHA = 0.2

#: raw samples kept per observe() key for the percentile digests — big
#: enough for stable p99s, small enough to bound hot-path memory
SVC_RING = 512


class Metrics:
    """Thread-safe counters + nanosecond timers, cheap enough for hot paths."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.ns = defaultdict(int)        # category -> total ns
        self.count = defaultdict(int)     # category/event -> occurrences
        self.latencies_ns: list[int] = [] # per-request response times
        self.record_latencies = False
        # key -> [ewma_ns, n, max_ns] service-time summaries (observe())
        self._svc: dict[str, list] = {}
        # key -> bounded ring of recent raw samples (ns) for percentiles
        self._svc_ring: dict[str, list] = {}

    @contextmanager
    def timer(self, category: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            dt = time.perf_counter_ns() - t0
            with self._lock:
                self.ns[category] += dt
                self.count[category] += 1

    def add_ns(self, category: str, ns: int) -> None:
        with self._lock:
            self.ns[category] += ns
            self.count[category] += 1

    def bump(self, event: str, n: int = 1) -> None:
        with self._lock:
            self.count[event] += n

    def record_latency(self, ns: int) -> None:
        if self.record_latencies:
            with self._lock:
                self.latencies_ns.append(ns)

    def observe(self, key: str, ns: int) -> None:
        """Fold one service time (nanoseconds) into ``key``'s EWMA.
        Keys follow the per-tenant convention (``svc::shard3``,
        ``svc::node1``, ``svc::aio::write_multi``) so :meth:`per_node`
        can collect a whole family at once."""
        with self._lock:
            st = self._svc.get(key)
            if st is None:
                self._svc[key] = [float(ns), 1, ns]
            else:
                st[0] += EWMA_ALPHA * (ns - st[0])
                st[1] += 1
                if ns > st[2]:
                    st[2] = ns
            ring = self._svc_ring.get(key)
            if ring is None:
                self._svc_ring[key] = [ns]
            elif len(ring) < SVC_RING:
                ring.append(ns)
            else:
                # overwrite round-robin: slot by total count keeps the
                # ring a uniform window over the most recent SVC_RING
                ring[self._svc[key][1] % SVC_RING] = ns

    def per_node(self, prefix: str = "svc") -> dict[str, dict]:
        """Service-time summaries observed under ``f"{prefix}::..."``:
        suffix -> ``{"ewma_us", "n", "max_us"}``.  The fail-slow detector
        input: one EWMA drifting off its peers is a limping shard/node."""
        pre = prefix + "::"
        with self._lock:
            return {k[len(pre):]: {"ewma_us": st[0] / 1e3, "n": st[1],
                                   "max_us": st[2] / 1e3}
                    for k, st in self._svc.items() if k.startswith(pre)}

    def digest(self, prefix: str = "svc") -> dict[str, dict]:
        """Latency digests for a key family: suffix -> ``{"ewma_us",
        "n", "max_us", "p50_us", "p99_us"}``.  Percentiles come from the
        bounded raw-sample ring (an EWMA averages a bimodal limping
        device into invisibility; the p99 is the fail-slow signal)."""
        pre = prefix + "::"
        with self._lock:
            rows = {k[len(pre):]: (list(st), sorted(self._svc_ring.get(k, ())))
                    for k, st in self._svc.items() if k.startswith(pre)}
        out = {}
        for suffix, (st, xs) in rows.items():
            row = {"ewma_us": st[0] / 1e3, "n": st[1], "max_us": st[2] / 1e3}
            for name, p in (("p50_us", 50.0), ("p99_us", 99.0)):
                if xs:
                    idx = min(len(xs) - 1,
                              int(round(p / 100.0 * (len(xs) - 1))))
                    row[name] = xs[idx] / 1e3
                else:
                    row[name] = 0.0
            out[suffix] = row
        return out

    # -- report helpers -----------------------------------------------------
    def breakdown(self) -> dict[str, float]:
        """Fractional time per category (paper Fig. 6a)."""
        total = sum(self.ns[c] for c in CATEGORIES) or 1
        return {c: self.ns[c] / total for c in CATEGORIES}

    def read_path(self) -> dict[str, float]:
        """Read-path summary: every counter plus the fraction of reads
        served without touching the backend (transit or tier hit)."""
        with self._lock:
            out = {c: self.count.get(c, 0) for c in READ_COUNTERS}
        served = out["read_hits"] + out["read_tier_hits"] + out["read_misses"]
        out["dram_hit_rate"] = ((out["read_hits"] + out["read_tier_hits"])
                                / served if served else 0.0)
        return out

    def commit_path(self) -> dict[str, float]:
        """Commit-path summary: chained-tx, group-commit and batched-log
        counters plus the coalescing rates (the fraction of fsync calls
        that rode a leader's commit, and of chains that rode another
        caller's log batch)."""
        with self._lock:
            out = {c: self.count.get(c, 0) for c in COMMIT_COUNTERS}
        calls = out["group_commits"] + out["group_commit_waiters"]
        out["coalesce_rate"] = (out["group_commit_waiters"] / calls
                                if calls else 0.0)
        chains = out["log_batches"] + out["log_batch_coalesced"]
        out["log_coalesce_rate"] = (out["log_batch_coalesced"] / chains
                                    if chains else 0.0)
        return out

    def zerocopy_path(self) -> dict[str, float]:
        """Zero-copy data-plane summary: pin/snapshot/link/fused-kernel
        counters plus ``pin_rate`` — the fraction of payload-carrying
        submits that crossed the engine without a copy."""
        with self._lock:
            out = {c: self.count.get(c, 0) for c in ZEROCOPY_COUNTERS}
        moved = out["copies_avoided"] + out["staging_copies"]
        out["pin_rate"] = out["copies_avoided"] / moved if moved else 0.0
        return out

    def tail_path(self) -> dict[str, float]:
        """Tail-latency summary: hedged-read + steering counters, the
        hedge win rate, and ``hedges_unaccounted`` — every fired hedge
        must end won or cancelled (0 when losers are cleaned up, the
        acceptance invariant for the hedged read path)."""
        with self._lock:
            out = {c: self.count.get(c, 0) for c in TAIL_COUNTERS}
        out["hedge_win_rate"] = (out["hedges_won"] / out["hedges_fired"]
                                 if out["hedges_fired"] else 0.0)
        out["hedges_unaccounted"] = (out["hedges_fired"] - out["hedges_won"]
                                     - out["hedges_cancelled"])
        return out

    def autotune_path(self) -> dict:
        """Control-plane summary: tick/move counters, the moves-per-tick
        rate (a healthy controller converges: the rate decays once the
        workload steadies), and the per-knob move breakdown."""
        with self._lock:
            out: dict = {c: self.count.get(c, 0) for c in AUTOTUNE_COUNTERS}
        out["move_rate"] = (out["autotune_moves"] / out["autotune_ticks"]
                            if out["autotune_ticks"] else 0.0)
        out["per_knob"] = self.per_tenant("autotune_moves")
        return out

    def kv_paging_path(self) -> dict[str, float]:
        """KV-paging summary: spill/restore/dedup/prefetch counters plus
        ``dedup_rate`` (fraction of spill requests resolved by content
        hash without a volume write) and ``prefetch_hit_rate`` (fraction
        of volume restores served from a decode-ahead read instead of a
        synchronous wait on the activate() path)."""
        with self._lock:
            out = {c: self.count.get(c, 0) for c in KV_PAGING_COUNTERS}
        asked = out["kv_spills"] + out["kv_dedup_hits"]
        out["dedup_rate"] = out["kv_dedup_hits"] / asked if asked else 0.0
        out["prefetch_hit_rate"] = (out["kv_prefetch_hits"]
                                    / out["kv_restores"]
                                    if out["kv_restores"] else 0.0)
        return out

    def per_tenant(self, prefix: str) -> dict[str, int]:
        """Collect per-tenant counters bumped as ``f"{prefix}::{t}"``
        (e.g. ``per_tenant('wfq_vbytes')`` -> tenant -> priced bytes)."""
        pre = prefix + "::"
        with self._lock:
            return {k[len(pre):]: v for k, v in self.count.items()
                    if k.startswith(pre)}

    def percentile_us(self, p: float) -> float:
        if not self.latencies_ns:
            return 0.0
        xs = sorted(self.latencies_ns)
        idx = min(len(xs) - 1, int(round(p / 100.0 * (len(xs) - 1))))
        return xs[idx] / 1e3

    def mean_us(self) -> float:
        if not self.latencies_ns:
            return 0.0
        return sum(self.latencies_ns) / len(self.latencies_ns) / 1e3

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ns": dict(self.ns),
                "count": dict(self.count),
                "n_latencies": len(self.latencies_ns),
            }

    def reset(self) -> None:
        with self._lock:
            self.ns.clear()
            self.count.clear()
            self.latencies_ns.clear()
            self._svc.clear()
            self._svc_ring.clear()


class ShardScorer:
    """Fail-slow detector over one :meth:`Metrics.digest` family.

    Classifies every member of a service-time key family
    (``svc::shard*`` / ``svc::node*``) against its PEERS — the fail-slow
    literature's "limplock" signature is one device drifting 10–100x off
    the cohort while still completing everything, so absolute thresholds
    lose the moment the workload shifts but a peer-relative ratio does
    not:

      ``healthy``   p99 < ``limping_ratio`` x the peer-median p50
      ``limping``   p99 >= that bar but below ``dead_ratio`` x
      ``dead``      p99 >= ``dead_ratio`` x the peer-median p50, or the
                    member was explicitly marked (heartbeat integration)

    The scorer also derives the two control outputs the data plane
    steers by: :meth:`hedge_delay_us` — the healthy-cohort p99, the
    classic hedged-request trigger (fire the backup only after the
    request has outlived what a healthy replica would take) — and
    :meth:`penalty` — a charge/placement multiplier (1.0 healthy,
    ``limping_penalty`` limping, ``dead_penalty`` dead) consumed by the
    WFQ pricing, the eviction pool and the placement policy.
    """

    def __init__(self, metrics: "Metrics", family: str = "shard", *,
                 prefix: str = "svc", limping_ratio: float = 4.0,
                 dead_ratio: float = 200.0, min_samples: int = 8,
                 limping_penalty: float = 4.0,
                 dead_penalty: float = 64.0) -> None:
        self.metrics = metrics
        self.family = family
        self.prefix = prefix
        self.limping_ratio = limping_ratio
        self.dead_ratio = dead_ratio
        self.min_samples = min_samples
        self.limping_penalty = limping_penalty
        self.dead_penalty = dead_penalty
        self._marked_dead: set[str] = set()

    def _rows(self) -> dict[str, dict]:
        dig = self.metrics.digest(self.prefix)
        return {k: v for k, v in dig.items() if k.startswith(self.family)}

    def mark_dead(self, member: str) -> None:
        """Heartbeat/fail-stop override: force ``member`` to ``dead``."""
        self._marked_dead.add(member)

    def clear_dead(self, member: str) -> None:
        self._marked_dead.discard(member)

    def table(self) -> dict[str, dict]:
        """Digest rows + a ``state`` per member (the scrub surface)."""
        rows = self._rows()
        ref = self._peer_median_p50(rows)
        out = {}
        for k, row in sorted(rows.items()):
            row = dict(row)
            row["state"] = self._state(k, row, ref)
            out[k] = row
        return out

    def states(self) -> dict[str, str]:
        return {k: row["state"] for k, row in self.table().items()}

    def limping(self) -> set[str]:
        """Members to steer around (limping OR dead)."""
        return {k for k, s in self.states().items() if s != "healthy"}

    def penalty(self, member: str) -> float:
        state = self.states().get(member, "healthy")
        if state == "dead":
            return self.dead_penalty
        if state == "limping":
            return self.limping_penalty
        return 1.0

    def hedge_delay_us(self, default_us: float = 0.0) -> float:
        """p99 of the healthy cohort — hedge a replicated read only once
        it has outlived what a healthy member would take."""
        rows = self._rows()
        ref = self._peer_median_p50(rows)
        healthy = sorted(row["p99_us"] for k, row in rows.items()
                        if self._state(k, row, ref) == "healthy"
                        and row["n"] >= self.min_samples)
        if not healthy:
            return default_us
        return healthy[len(healthy) // 2]

    def _peer_median_p50(self, rows: dict[str, dict]) -> float:
        xs = sorted(row["p50_us"] for row in rows.values()
                    if row["n"] >= self.min_samples and row["p50_us"] > 0)
        if not xs:
            return 0.0
        # LOWER median: with an even cohort (2 replicas is the common
        # case) the upper median would let a slow member become its own
        # reference and classify itself healthy
        return xs[(len(xs) - 1) // 2]

    def _state(self, member: str, row: dict, ref: float) -> str:
        if member in self._marked_dead:
            return "dead"
        if ref <= 0 or row["n"] < self.min_samples:
            return "healthy"          # not enough evidence to steer yet
        ratio = row["p99_us"] / ref
        if ratio >= self.dead_ratio:
            return "dead"
        if ratio >= self.limping_ratio:
            return "limping"
        return "healthy"
