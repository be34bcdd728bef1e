"""Striped multi-device volume manager (RAID-0, optional replication).

Composes N ``BlockDevice`` shards — each the paper's full stack (transit
cache over BTT over PMem) — into one logical LBA space:

  * **striping**: logical stripe ``st = lba // stripe_blocks`` lives on
    shard ``st % n_shards``; consecutive stripes rotate shards so a
    sequential writer spreads over all PMem DIMM sets;
  * **shared eviction pool**: one :class:`SharedEvictionPool` drains every
    shard's write-back queue congestion-aware instead of per-device
    thread pools;
  * **global conditional bypass**: a write miss transits straight to BTT
    when its shard's buffer is full (the paper's per-device rule) OR when
    the volume's aggregate staged bytes cross ``bypass_watermark`` — under
    volume-wide pressure the staging detour stops paying for itself
    before any single shard is full;
  * **per-tenant QoS**: token-bucket rate caps and weighted fair (SFQ)
    admission, so many clients share one volume predictably;
  * **crash recovery**: per-shard BTT Flog replay (device open) plus the
    chained-tx redo journal (:class:`VolumeJournal`) replayed in txid
    order — a logical write of ANY size (up to the journal ring) is
    whole-object all-or-nothing: ``write_multi`` journals it as a chain
    of records whose tail header is the single commit point;
  * **group commit**: concurrent ``fsync`` callers coalesce behind a
    :class:`~repro_torch.volume.journal.GroupCommitter` leader — one drain +
    one applied-mark superblock pass per batch (``commit_window``
    gathers followers), amortizing the sync round trip across tenants;
  * **batched log pipeline**: concurrent ``write_multi`` chains coalesce
    behind a :class:`~repro_torch.volume.journal.LogBatcher` leader into ONE
    slot-shard journal pass — one ``_txlock`` acquisition, headers
    grouped per shard, one tail pass per batch (``log_window`` gathers
    followers) — so small-write-heavy tenants stop paying a serialized
    journal pass per ``log()``;
  * **tier-aware WFQ**: tenant reads pass the gate tagged with their
    probed serving tier and are charged virtual time at
    ``tier_hit_cost_frac`` for DRAM service; batched log writes are
    charged once per batch to their constituent tenants
    (``WFQGate.charge_batch``) — one coherent fairness story across
    reads, writes and journal traffic;
  * **unified admission** (:class:`~repro_torch.volume.AdmissionPolicy`): the
    bypass watermark, the read-tier fill policy (sequential-scan bypass)
    and tier-aware QoS read pricing live behind one object consulted by
    the shard caches, the tier and this volume;
  * **layered read path** (``read_tier_bytes > 0``): one clean DRAM
    :class:`~repro_torch.volume.read_tier.ReadTier` fronts every shard
    (tier -> transit cache -> BTT), populated on read miss and on
    eviction writeback, invalidated by writes — never journaled;
  * **degraded reads + resync** (``replicas > 1``): every read is
    verified against a write-time crc ledger; a primary-shard copy that
    fails verification is served from a replica instead, and the
    divergent block is queued to the background
    :class:`~repro_torch.volume.read_tier.ReplicaResyncer` for repair.

Crash semantics: like any write-back device, writes are durable at
``fsync``.  After a crash, a journaled multi-block write is either fully
visible or fully invisible — whole-object, even when it spans many
journal records (the chain replays only if its tail header landed);
un-fsynced single-block writes that landed *after* a journaled write to
the same blocks may be rolled back to the journaled image when that
journal record replays.  With ``persist_ledger`` (default when reads
are verified) the write-crc ledger summary is persisted at every
checkpoint, so a REOPENED volume verifies reads — and can degrade to a
replica — before the first overwrite instead of starting blind.
"""
from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib

import numpy as np

from repro_torch.core import make_device
from repro_torch.core.metrics import Metrics, ShardScorer
from repro_torch.core.pmem import LatencyModel

from .admission import AdmissionPolicy
from .aio import AsyncIOEngine, RegisteredBuf, hedged_read as _hedged_read


from .autotune import Controller
from .evict_pool import SharedEvictionPool
from .journal import GroupCommitter, LogBatcher, VolumeJournal
from .qos import TenantSpec, TokenBucket, WFQGate
from .read_tier import ReadTier, ReplicaResyncer


def _unwrap(payload):
    """A :class:`RegisteredBuf` handle's backing array — the sync write
    surface accepts the same handles the async engine pins, so a caller
    holding a registered pool never needs two code paths."""
    return payload.data if isinstance(payload, RegisteredBuf) else payload

_SB_MAGIC = "caiti-volume-v1"
_LEDGER_ENTRY = "<QI"        # lba, crc32
_LEDGER_ENTRY_SIZE = struct.calcsize(_LEDGER_ENTRY)


class VolumeConfig:
    """Geometry + policy for a striped volume (kept explicit for the
    superblock round-trip; all sizes in 4K blocks unless noted)."""

    def __init__(self, *, n_lbas: int, n_shards: int = 4,
                 stripe_blocks: int = 64, replicas: int = 1,
                 policy: str = "caiti", block_size: int = 4096,
                 cache_bytes: int = 64 << 20, shared_workers: int = 4,
                 bypass_watermark: float = 0.9, journal_slots: int = 64,
                 journal_span: int = 8, max_inflight: int = 16,
                 read_tier_bytes: int = 0, n_sockets: int = 1,
                 verify_reads: bool | None = None,
                 commit_window: float = 0.0,
                 log_window: float = 0.0,
                 scan_threshold: int = 64,
                 tier_hit_cost_frac: float = 0.125,
                 persist_ledger: bool = True,
                 aio_workers: int = 2,
                 hedge_delay_us: float = 0.0) -> None:
        assert n_shards >= 1 and stripe_blocks >= 1
        assert 1 <= replicas <= n_shards
        assert policy not in ("raw", "dax"), \
            "volume shards need BTT atomicity (journal + recovery)"
        self.n_lbas = n_lbas
        self.n_shards = n_shards
        self.stripe_blocks = stripe_blocks
        self.replicas = replicas
        self.policy = policy
        self.block_size = block_size
        self.cache_bytes = cache_bytes
        self.shared_workers = shared_workers
        self.bypass_watermark = bypass_watermark
        self.journal_slots = journal_slots
        self.journal_span = journal_span
        self.max_inflight = max_inflight
        self.read_tier_bytes = read_tier_bytes
        self.n_sockets = n_sockets
        self.commit_window = commit_window
        self.log_window = log_window
        self.scan_threshold = scan_threshold
        self.tier_hit_cost_frac = tier_hit_cost_frac
        # async frontend: dispatch threads for the lazily-created
        # AsyncIOEngine (0 = deterministic inline mode)
        self.aio_workers = aio_workers
        # hedged replicated reads: wait this long on the primary before
        # firing the replica (0 = auto: the ShardScorer's healthy-cohort
        # median p99)
        self.hedge_delay_us = hedge_delay_us
        # reads are verified (and can degrade to a replica) only when a
        # replica exists to fall back to — single-copy volumes pay nothing
        self.verify_reads = (replicas > 1 if verify_reads is None
                             else verify_reads)
        # write-crc ledger region: persisted at checkpoint so a reopened
        # volume verifies reads before its first overwrite
        self.persist_ledger = persist_ledger and self.verify_reads

    # derived geometry -------------------------------------------------------
    @property
    def n_stripes(self) -> int:
        return -(-self.n_lbas // self.stripe_blocks)

    @property
    def rows_per_shard(self) -> int:
        return -(-self.n_stripes // self.n_shards)

    @property
    def data_per_shard(self) -> int:
        return self.rows_per_shard * self.stripe_blocks

    def journal_blocks_per_shard(self) -> int:
        slots_here = -(-self.journal_slots // self.n_shards)
        return slots_here * (1 + self.journal_span)

    @property
    def ledger_blocks_per_shard(self) -> int:
        if not self.persist_ledger:
            return 0
        total = -(-self.n_lbas * _LEDGER_ENTRY_SIZE // self.block_size)
        return -(-total // self.n_shards)

    @property
    def meta_blocks(self) -> int:
        # superblock + crc-ledger region + journal region
        return (1 + self.ledger_blocks_per_shard
                + self.journal_blocks_per_shard())

    @property
    def shard_n_lbas(self) -> int:
        return self.meta_blocks + self.data_per_shard * self.replicas

    def to_sb(self, shard: int, uuid: str, applied_txid: int = 0) -> dict:
        return {"magic": _SB_MAGIC, "uuid": uuid, "shard": shard,
                "n_shards": self.n_shards, "n_lbas": self.n_lbas,
                "stripe_blocks": self.stripe_blocks,
                "replicas": self.replicas,
                "journal_slots": self.journal_slots,
                "journal_span": self.journal_span,
                "ledger_blocks": self.ledger_blocks_per_shard,
                "applied_txid": applied_txid}


class StripedVolume:
    """The logical device: bio-free convenience API (write/read/flush/fsync)
    mirroring ``BlockDevice`` plus ``write_multi`` (atomic) and tenants."""

    #: ``write_multi`` is whole-object atomic (chained-tx journal), so
    #: clients like the checkpoint blockstore can commit large objects in
    #: one logical write instead of a double-write + root-flip protocol
    supports_chained_tx = True

    def __init__(self, shards, cfg: VolumeConfig, *, uuid: str,
                 evict_pool: SharedEvictionPool | None = None,
                 read_tier: ReadTier | None = None) -> None:
        self.shards = list(shards)
        self.cfg = cfg
        self.uuid = uuid
        self.block_size = cfg.block_size
        self.n_lbas = cfg.n_lbas
        self.pool = evict_pool
        self.metrics = Metrics()          # volume-level (degraded/resync)
        # fail-slow scoring: per-shard p50/p99 digests over the
        # svc::shard{i} sample rings feed the healthy/limping/dead
        # verdicts that hedging and steering consume
        self.scorer = ShardScorer(self.metrics, family="shard")
        self.read_tier = read_tier
        # write-time crc ledger: arbitrates primary-vs-replica divergence
        # (in-DRAM only — after reopen unknown lbas are simply not verified)
        self._crcs: dict[int, int] = {}
        self._txlock = threading.Lock()
        self._caches = [d.impl for d in self.shards
                        if hasattr(d.impl, "bypass_hook")]
        self._total_cache_slots = sum(len(c._slots) for c in self._caches)
        watermark_slots = max(1, int(
            cfg.bypass_watermark * self._total_cache_slots)) \
            if self._caches else 0
        # one AdmissionPolicy unifies bypass watermark, tier-fill (scan)
        # policy and QoS read pricing for every layer of the stack
        self.admission = AdmissionPolicy(
            staged_slots_fn=self._staged_slots,
            watermark_slots=watermark_slots,
            scan_threshold=cfg.scan_threshold,
            tier_hit_cost_frac=cfg.tier_hit_cost_frac)
        for c in self._caches:
            c.bypass_hook = self.admission.should_bypass_write
            c.admission = self.admission
        if read_tier is not None:
            read_tier.admission = self.admission
        self.journal = VolumeJournal(
            [d.impl.btt for d in self.shards],
            base_lba=1 + cfg.ledger_blocks_per_shard,
            n_slots=cfg.journal_slots, span=cfg.journal_span,
            block_size=cfg.block_size)
        # group commit: concurrent fsync callers share one drain +
        # applied-mark superblock pass (window gathers followers)
        self._committer = GroupCommitter(self._commit_group,
                                         window=cfg.commit_window)
        # batched log pipeline: concurrent write_multi chains coalesce
        # behind a leader into ONE slot-shard journal pass under one
        # _txlock acquisition (log_window gathers followers)
        self._log_batcher = LogBatcher(self._flush_log_batch,
                                       window=cfg.log_window)
        self._ledger_count = 0
        self._ledger_crc = 0
        # QoS (lazy: volumes without tenants pay nothing)
        self._gate: WFQGate | None = None
        self._buckets: dict[str, TokenBucket] = {}
        self.read_debits: dict[str, int] = {}
        self.recovery_stats: dict = {}
        # async submission/completion frontend (lazy: blocking-only
        # callers pay nothing; first submit() builds the engine)
        self._aio: AsyncIOEngine | None = None
        # self-tuning control plane (attach_autotuner): None = every
        # knob frozen at its configured value (zero-overhead passthrough)
        self.autotuner: Controller | None = None
        self._autotune_prev: dict | None = None
        # background replica repair rides the shared eviction pool (its
        # own daemon thread when the policy has no pool, e.g. plain btt)
        self.resyncer = (ReplicaResyncer(self, pool=evict_pool)
                         if cfg.replicas > 1 else None)

    # -------------------------------------------------------------- mapping
    def _map(self, lba: int, replica: int = 0) -> tuple[int, int]:
        assert 0 <= lba < self.n_lbas, f"lba {lba} out of volume range"
        cfg = self.cfg
        st, within = divmod(lba, cfg.stripe_blocks)
        row, shard = divmod(st, cfg.n_shards)
        shard = (shard + replica) % cfg.n_shards
        local = (cfg.meta_blocks + cfg.data_per_shard * replica
                 + row * cfg.stripe_blocks + within)
        return shard, local

    def _staged_slots(self) -> int:
        return sum(c.staged_slots() for c in self._caches)

    # ------------------------------------------------------------------ QoS
    def add_tenant(self, name: str, weight: float = 1.0,
                   rate_mbps: float = 0.0, burst_bytes: int = 4 << 20) -> None:
        if self._gate is None:
            # the unified AdmissionPolicy prices the gate's virtual time
            # (tier-aware reads, batched log charges)
            self._gate = WFQGate(max_inflight=self.cfg.max_inflight,
                                 policy=self.admission)
        self._gate.set_tenant(name, weight)
        if rate_mbps > 0:
            self._buckets[name] = TokenBucket(rate_mbps * 1e6,
                                              burst_bytes=burst_bytes)

    def _admit(self, tenant: str | None, nbytes: int, op: str = "write",
               tier: str | None = None, shard: int | None = None):
        if tenant is None or self._gate is None:
            return None
        if op == "write":
            # reads settle their token-bucket debit post-service
            # (_debit_read: DRAM hits never sleep on the PMem budget)
            bucket = self._buckets.get(tenant)
            if bucket is not None:
                bucket.acquire(nbytes)
        # shard= tags the op's target device: work headed for a limping
        # shard is priced UP by the scorer's penalty (fail-slow steering)
        cost = self.admission.op_charge(nbytes, op, tier, shard=shard)
        self.metrics.bump(f"wfq_vbytes::{tenant}", int(cost))
        if shard is not None and self.admission.shard_penalty(shard) > 1.0:
            self.metrics.bump("steered_charges")
        return self._gate.admit(tenant, nbytes, op=op, tier=tier,
                                shard=shard)

    def _release(self, ticket) -> None:
        if ticket is not None:
            self._gate.done(ticket)

    # ------------------------------------------------------------------ I/O
    @staticmethod
    def _crc(data) -> int:
        if isinstance(data, (bytes, bytearray, memoryview)):
            return zlib.crc32(data)
        return zlib.crc32(np.ascontiguousarray(data, dtype=np.uint8))

    def _write_block(self, lba: int, data) -> None:
        if self.cfg.verify_reads:
            self._crcs[lba] = self._crc(data)
        for r in range(self.cfg.replicas):
            shard, local = self._map(lba, r)
            t0 = time.perf_counter_ns()
            self.shards[shard].write(local, data)
            self.metrics.observe(f"svc::shard{shard}",
                                 time.perf_counter_ns() - t0)

    def _pick_good_copy(self, lba: int, candidates: list[bytes]):
        """The copy to trust among divergent replicas: the write-crc
        ledger decides; with no ledger entry (reopened volume — the
        ledger is DRAM-only), a strict majority (>= 2 matching copies)
        decides.  A 1-vs-1 tie with no ledger is UNDECIDABLE: return
        None so the resyncer leaves the divergence flagged instead of
        possibly overwriting the last good copy with the corrupt one."""
        want = self._crcs.get(lba)
        if want is not None:
            for c in candidates:
                if self._crc(c) == want:
                    return c
            return None
        best, best_n = None, 0
        for c in candidates:
            n = candidates.count(c)
            if n > best_n:
                best, best_n = c, n
        return best if best_n >= 2 else None

    def _ledger_disagrees(self, lba: int, data) -> bool:
        """True iff the write-crc ledger has an entry for ``lba`` that
        does NOT match ``data`` (the resyncer's pre-rewrite recheck: a
        foreground write that landed mid-repair owns the block)."""
        want = self._crcs.get(lba)
        return want is not None and self._crc(data) != want

    def write(self, lba: int, data, tenant: str | None = None) -> int:
        """One-block write: atomic per shard BTT, no journaling needed."""
        data = _unwrap(data)
        ticket = self._admit(tenant, self.block_size,
                             shard=self._map(lba, 0)[0])
        try:
            self._write_block(lba, data)
            return 0
        finally:
            self._release(ticket)

    def write_multi(self, lba: int, blocks, tenant: str | None = None) -> int:
        """Multi-block logical write with WHOLE-OBJECT all-or-nothing
        crash semantics: the write is journaled as one chained
        transaction (``journal_span`` blocks per link, tail header as the
        single commit point), so a crash anywhere surfaces either the
        complete new object or the complete old one — never a torn mix.
        Bounded by the journal ring (``journal.max_chain_blocks()``).

        Chains ride the batched log pipeline: concurrent callers coalesce
        behind a :class:`~repro_torch.volume.journal.LogBatcher` leader into
        one slot-shard journal pass (``log_window`` gathers followers).
        The token bucket still caps each caller's rate up front, and the
        chain occupies a WFQ in-flight slot (``op='log'``) so chained
        writes stay ``max_inflight``-bounded and SFQ-ordered against the
        tenant's accumulated virtual time — but the admit itself prices
        ~nothing (one clamped byte): the actual bytes are charged once
        per BATCH to the constituent tenants at flush
        (``WFQGate.charge_batch``), so a small-write-heavy tenant no
        longer pays a full gate-pricing pass per ``log()``."""
        blocks = [_unwrap(b) for b in blocks]
        if len(blocks) == 1:
            ticket = self._admit(tenant, self.block_size)
            try:
                self._write_block(lba, blocks[0])
                return 0
            finally:
                self._release(ticket)
        if tenant is not None:
            bucket = self._buckets.get(tenant)
            if bucket is not None:
                bucket.acquire(self.block_size * len(blocks))
        ticket = None
        if tenant is not None and self._gate is not None:
            ticket = self._gate.admit(tenant, 0, op="log")
        try:
            self._write_tx(lba, blocks, tenant)
            return 0
        finally:
            self._release(ticket)

    def _write_tx(self, lba: int, blocks, tenant: str | None = None) -> None:
        self._log_batcher.submit(lba, blocks, tenant)

    def _flush_log_batch(self, entries) -> None:
        """LogBatcher flush: ONE ``_txlock`` acquisition journals every
        entry of the batch in shared slot-shard passes and applies the
        in-place writes group by group (``apply_cb``): a member's tails
        land (phase 3) before its in-place writes, so recovery rolls it
        forward whole if anything tears — and every member is applied
        before a later sub-group can reuse its journal slots or mark it
        checkpointed (the multi-group ring-wrap hazard)."""
        with self._txlock:
            def apply_entry(k: int, txids: list[int]) -> None:
                e = entries[k]
                e.txids = txids
                for i, blk in enumerate(e.blocks):
                    self._write_block(e.lba + i, blk)

            txid_lists = self.journal.log_batch(
                [(e.lba, e.blocks) for e in entries],
                checkpoint_cb=self._checkpoint_locked,
                apply_cb=apply_entry)
            n_links = 0
            per_tenant: dict[str, int] = {}
            for e, txids in zip(entries, txid_lists):
                n_links += len(txids)
                if e.tenant is not None:
                    per_tenant[e.tenant] = (per_tenant.get(e.tenant, 0)
                                            + e.nbytes)
            self.metrics.bump("chain_txs", n_links)
            self.metrics.bump("log_batches")
            self.metrics.bump("log_batch_links", n_links)
            if len(entries) > 1:
                self.metrics.bump("log_batch_coalesced", len(entries) - 1)
            # tier-aware WFQ: the whole batch's log traffic is charged to
            # its constituent tenants in one gate pass
            if self._gate is not None and per_tenant:
                for t, cost in self._gate.charge_batch(per_tenant,
                                                       op="log").items():
                    self.metrics.bump(f"wfq_vbytes::{t}", int(cost))

    def _shard_read(self, shard: int, local: int,
                    out: np.ndarray | None = None):
        """(data, source) from one shard: 'transit' | 'tier' | 'backend'."""
        impl = self.shards[shard].impl
        t0 = time.perf_counter_ns()
        if hasattr(impl, "read_ex"):
            res = impl.read_ex(local, out=out)
        else:
            res = impl.read(local, out=out), "backend"
        self.metrics.observe(f"svc::shard{shard}",
                             time.perf_counter_ns() - t0)
        return res

    def _debit_read(self, tenant: str | None, source: str,
                    pre_tier: str | None = None) -> None:
        """Tier-aware QoS accounting: a DRAM-served read (transit or
        tier hit) is charged a fraction of the PMem price, so a tier-hot
        tenant is not throttled like a PMem-bound one.  Both disciplines
        settle post-service: the token bucket via ``charge`` debt, the
        WFQ gate via ``WFQGate.charge`` for the remainder a read that
        served WORSE than its probed admission tag (``pre_tier``) turned
        out to owe — one-sided, so a probe raced by a fill keeps its
        conservative price."""
        if tenant is None:
            return
        cost = self.admission.read_charge(self.block_size, source)
        self.read_debits[tenant] = self.read_debits.get(tenant, 0) + cost
        if self._gate is not None:
            pre = self.admission.op_charge(self.block_size, "read", pre_tier)
            if cost > pre:
                extra = self._gate.charge(tenant, cost - pre, op="read",
                                          tier="backend")
                self.metrics.bump(f"wfq_vbytes::{tenant}", int(extra))
        bucket = self._buckets.get(tenant)
        if bucket is None or cost <= 0:
            return
        if source == "backend":
            bucket.acquire(cost)       # PMem reads are rate-enforced
        else:
            bucket.charge(cost)        # DRAM hits never sleep: debt only

    def _probe_read_tier(self, shard: int, local: int) -> str | None:
        """Cheap non-mutating guess of a read's serving tier ('transit'
        | 'tier' | None) so WFQ admission can price it before the stack
        is walked."""
        impl = self.shards[shard].impl
        probe = getattr(impl, "probe", None)
        return probe(local) if probe is not None else None

    def read(self, lba: int, out: np.ndarray | None = None,
             tenant: str | None = None, replica: int = 0) -> np.ndarray:
        """Layered read: tier -> primary shard (transit cache -> BTT) ->
        replica (degraded).  The tier probe happens inside the shard's
        cache; this level verifies the result and falls back.  Tenant
        reads pass the WFQ gate tagged ``op='read'`` with the probed
        tier — ``tier_hit_cost_frac`` price when the probe found the
        block DRAM-resident, full PMem price otherwise (ROADMAP: gate
        tags no longer charge reads nothing).  ``replica=`` serves the
        read from that copy instead of the primary (the hedge path's
        backup leg); verification and degraded fallback are unchanged."""
        replica = replica % self.cfg.replicas if replica else 0
        shard, local = self._map(lba, replica)
        ticket = None
        pre_tier = None
        if tenant is not None and self._gate is not None:
            pre_tier = self._probe_read_tier(shard, local)
            ticket = self._admit(tenant, self.block_size, op="read",
                                 tier=pre_tier, shard=shard)
        try:
            return self._read_verified(lba, shard, local, out, tenant,
                                       pre_tier)
        finally:
            self._release(ticket)

    def _read_verified(self, lba: int, shard: int, local: int,
                       out: np.ndarray | None, tenant: str | None,
                       pre_tier: str | None = None):
        data, source = self._shard_read(shard, local, out=out)
        if not self.cfg.verify_reads:
            self._debit_read(tenant, source, pre_tier)
            return data
        want = self._crcs.get(lba)
        if want is None or self._crc(data) == want:
            self._debit_read(tenant, source, pre_tier)
            return data
        # a read racing a write can see the new ledger entry before the
        # staged block is visible — one primary re-read (through the
        # transit cache, which serves staged data) settles that race
        # without a replica detour
        data, source = self._shard_read(shard, local, out=out)
        want = self._crcs.get(lba)
        if want is None or self._crc(data) == want:
            self._debit_read(tenant, source, pre_tier)
            return data
        self.metrics.bump("verify_failures")
        self._debit_read(tenant, "backend", pre_tier)  # detours: PMem price
        last_alt = None
        for r in range(1, self.cfg.replicas):
            s2, l2 = self._map(lba, r)
            alt = self.shards[s2].read(l2)
            if self._crc(alt) != want:
                last_alt = alt
                continue
            # degraded read: replica copy verified — serve it, read-repair
            # the tier under the PRIMARY key (later reads hit good data
            # even before the background resync lands), queue the repair
            self.metrics.bump("degraded_reads")
            tier = self.read_tier
            if tier is not None:
                tier.invalidate((shard, local))
                tier.insert((shard, local), alt)
            if self.resyncer is not None:
                self.resyncer.request(lba)
            if out is not None:
                out[:] = alt
                return out
            return alt
        if last_alt is not None and bytes(last_alt) == bytes(data):
            # every copy agrees, only the ledger disagrees: a mid-flight
            # write (or stale ledger), not corruption — serve it quietly
            self.metrics.bump("verify_races")
            return data
        # no copy matches the ledger: surface the primary (scrub/resync
        # will keep flagging it) rather than invent data
        self.metrics.bump("unrecoverable_reads")
        return data

    # ----------------------------------------------------------- tail latency
    def refresh_tail_state(self) -> dict:
        """One tail-state pass: recompute the :class:`ShardScorer`'s
        healthy/limping/dead verdicts from the per-shard service-time
        digests and push the penalties into every steering hook — WFQ
        ``op_charge`` pricing (limping shards cost more virtual time)
        and the shared eviction pool's drain order (limping backlogs
        drain last).  Returns the per-shard state map.  Called from
        ``scrub()``; operators and benches may call it on their own
        cadence."""
        states = self.scorer.states()
        pens: dict[int, float] = {}
        for member in states:
            if member.startswith("shard"):
                try:
                    idx = int(member[5:])
                except ValueError:
                    continue
                pens[idx] = self.scorer.penalty(member)
        self.admission.set_shard_penalties(pens)
        if self.pool is not None:
            limp = [self.shards[i].impl for i, p in pens.items()
                    if p > 1.0 and i < len(self.shards)
                    and hasattr(self.shards[i].impl, "_evict_slot")]
            self.pool.set_limping(
                limp,
                on_steer=lambda: self.metrics.bump("steered_evictions"))
        return states

    def hedge_delay(self) -> float:
        """Seconds to wait on the primary before firing the hedge leg:
        the configured ``hedge_delay_us``, or (when 0 = auto) the
        scorer's healthy-cohort median p99 — 1 ms until the digests
        warm up."""
        us = self.cfg.hedge_delay_us
        if us <= 0:
            us = self.scorer.hedge_delay_us(default_us=1000.0)
        return max(us, 1.0) / 1e6

    def hedged_read(self, lba: int, out=None, tenant: str | None = None,
                    delay_s: float | None = None):
        """Tail-tolerant replicated read: submit the primary, wait one
        hedge delay, and if it has not completed fire the SAME read
        against the replica — first completion wins, the loser is
        cancelled through the engine's per-ticket cancel path (releasing
        any pinned registered buffers).  Unreplicated volumes fall back
        to a plain :meth:`read`.  Counters (``hedges_fired`` ==
        ``hedges_won`` + ``hedges_cancelled``) surface in
        ``Metrics.tail_path()``."""
        if self.cfg.replicas < 2:
            return self.read(lba, out=out, tenant=tenant)
        delay = self.hedge_delay() if delay_s is None else delay_s
        return _hedged_read(self, lba, delay_s=delay, out=out,
                            tenant=tenant)

    # ----------------------------------------------------- control plane
    def attach_autotuner(self, controller: Controller | None = None) \
            -> Controller:
        """Attach a self-tuning :class:`~repro_torch.volume.autotune.Controller`
        (a stock one when None).  The controller is seeded from the LIVE
        config — it tunes from where the operator left the knobs, and
        every subsequent :meth:`autotune_step` observes the metrics
        layer and applies bounded, clamped knob moves online.  Without
        an attached controller ``autotune_step`` is a no-op and every
        knob stays frozen at its configured value."""
        if controller is None:
            from .autotune import make_default_controller
            controller = make_default_controller()
        seed = {"commit_window_us": self.cfg.commit_window * 1e6,
                "log_window_us": self.cfg.log_window * 1e6,
                "bypass_watermark": self.cfg.bypass_watermark,
                "scan_threshold": float(self.cfg.scan_threshold)}
        if self.cfg.hedge_delay_us > 0:     # 0 = scorer auto: keep the
            seed["hedge_delay_us"] = self.cfg.hedge_delay_us  # default
        controller.bind(seed)
        self.autotuner = controller
        self._autotune_prev = None
        return controller

    def _autotune_counters(self) -> dict:
        """Cumulative counter snapshot the signal window diffs against."""
        out: dict[str, float] = {}
        for k in ("read_hits", "read_misses", "read_tier_hits",
                  "tier_fill_bypassed", "bypass_writes", "bg_evictions"):
            out[k] = 0
        for d in self.shards:
            snap = d.metrics.snapshot()["count"]
            for k in out:
                out[k] += snap.get(k, 0)
        vol = self.metrics.snapshot()["count"]
        for k in ("group_commits", "group_commit_waiters", "log_batches",
                  "log_batch_coalesced"):
            out[k] = vol.get(k, 0)
        return out

    def autotune_signals(self) -> dict:
        """One signal window for the controller: per-op rates computed
        from the metrics layer's counter DELTAS since the previous call,
        plus the instantaneous occupancy/tail/zero-copy state.  Also the
        operator-facing view of what the control plane sees."""
        cur = self._autotune_counters()
        prev = self._autotune_prev or {k: 0 for k in cur}
        self._autotune_prev = cur
        d = {k: cur[k] - prev.get(k, 0) for k in cur}
        reads = d["read_hits"] + d["read_misses"] + d["read_tier_hits"]
        writes = d["bypass_writes"] + d["bg_evictions"]
        fsyncs = d["group_commits"] + d["group_commit_waiters"]
        logs = d["log_batches"] + d["log_batch_coalesced"]
        ops = max(1, reads + writes + logs)
        sig = {
            "ops": reads + writes + logs,
            "fsync_rate": fsyncs / ops,
            "coalesce_rate": (d["group_commit_waiters"] / fsyncs
                              if fsyncs else 0.0),
            "log_rate": logs / ops,
            "log_coalesce_rate": (d["log_batch_coalesced"] / logs
                                  if logs else 0.0),
            "stall_rate": 0.0,      # caiti shards bypass instead of stall
            "bypass_rate": (d["bypass_writes"] / writes if writes else 0.0),
            "staged_frac": (self._staged_slots() / self._total_cache_slots
                            if self._total_cache_slots else 0.0),
            "read_rate": reads / ops,
            "tier_hit_rate": ((d["read_hits"] + d["read_tier_hits"]) / reads
                              if reads else 0.0),
            "scan_denial_rate": (d["tier_fill_bypassed"] / reads
                                 if reads else 0.0),
        }
        states = self.scorer.states()
        sig["limping"] = any(s != "healthy" for s in states.values())
        sig["healthy_p99_us"] = self.scorer.hedge_delay_us(default_us=0.0)
        shard_digest = self.metrics.digest()
        p99s = [row["p99_us"] for k, row in shard_digest.items()
                if k.startswith("shard")]
        if p99s:
            sig["p99_us"] = max(p99s)
        if self._aio is not None:
            sig["pin_rate"] = self.metrics.zerocopy_path()["pin_rate"]
        debts = self.metrics.per_tenant("wfq_vbytes")
        total_debt = sum(debts.values())
        if total_debt:
            sig["wfq_debt_share"] = max(debts.values()) / total_debt
        return sig

    def autotune_step(self) -> dict:
        """One control tick: collect the signal window, let the attached
        controller vote, and apply whatever knobs it moved — group/log
        windows, the bypass watermark (converted to aggregate slots for
        the admission layer), the scan threshold, and the hedge delay.
        Returns the applied moves (``{}`` with no controller attached —
        the frozen-knob passthrough)."""
        if self.autotuner is None:
            return {}
        changes = self.autotuner.observe(self.autotune_signals())
        if changes:
            self._apply_knobs(changes)
            self.metrics.bump("autotune_moves", len(changes))
            for name in changes:
                self.metrics.bump(f"autotune_moves::{name}")
        self.metrics.bump("autotune_ticks")
        return changes

    def _apply_knobs(self, changes: dict) -> None:
        cfg = self.cfg
        if "commit_window_us" in changes:
            cfg.commit_window = changes["commit_window_us"] / 1e6
            self._committer.window = cfg.commit_window
        if "log_window_us" in changes:
            cfg.log_window = changes["log_window_us"] / 1e6
            self._log_batcher.window = cfg.log_window
        retune: dict = {}
        if "bypass_watermark" in changes:
            cfg.bypass_watermark = changes["bypass_watermark"]
            if self._total_cache_slots:
                retune["watermark_slots"] = max(1, int(
                    cfg.bypass_watermark * self._total_cache_slots))
        if "scan_threshold" in changes:
            cfg.scan_threshold = int(changes["scan_threshold"])
            retune["scan_threshold"] = cfg.scan_threshold
        if retune:
            self.admission.retune(**retune)
        if "hedge_delay_us" in changes:
            cfg.hedge_delay_us = changes["hedge_delay_us"]

    # --------------------------------------------------------- async frontend
    def aio_engine(self, *, n_workers: int | None = None,
                   max_inflight_per_tenant: int | None = None) \
            -> AsyncIOEngine:
        """The volume's :class:`~repro_torch.volume.aio.AsyncIOEngine`,
        created on first use.  ``n_workers=0`` selects deterministic
        inline mode (ops execute during ``poll``/``wait`` — the crash
        harness's replayable schedule).  The kwargs configure the FIRST
        call only; an explicit kwarg that contradicts the live engine
        asserts instead of silently handing back the wrong mode (a
        crash harness must never silently get a threaded engine)."""
        if self._aio is None:
            self._aio = AsyncIOEngine(
                self,
                n_workers=self.cfg.aio_workers if n_workers is None
                else n_workers,
                max_inflight_per_tenant=self.cfg.max_inflight
                if max_inflight_per_tenant is None
                else max_inflight_per_tenant)
        else:
            assert n_workers is None \
                or n_workers == len(self._aio._workers), \
                f"aio engine already running {len(self._aio._workers)} " \
                f"workers; cannot switch to {n_workers}"
            assert max_inflight_per_tenant is None \
                or max_inflight_per_tenant \
                == self._aio.max_inflight_per_tenant, \
                "aio engine already running a different in-flight bound"
        return self._aio

    def submit(self, op: str, lba: int = 0, data=None, blocks=None,
               tenant: str | None = None, block: bool = False,
               link_to=None, out=None, replica: int = 0):
        """Asynchronous submission: queue ``op`` ('write' | 'write_multi'
        | 'read' | 'fsync' | 'flush') and return its ticket immediately.
        Completions surface on :meth:`poll`; per-op failures (injected
        device errors, journal-ring overflow, a tenant over its
        in-flight bound) fail the TICKET, never the stack.
        ``block=True`` waits out the in-flight window instead of failing
        the ticket (blocking backpressure for batch producers).
        ``link_to=`` chains the ticket behind a parent (IO_LINK: failed
        parent cancels the chain with ECANCELED); ``out=`` lands a read
        directly in the caller's (registered) array; ``replica=`` routes
        a read to that copy (the hedge path's backup leg)."""
        return self.aio_engine().submit(op, lba=lba, data=data,
                                        blocks=blocks, tenant=tenant,
                                        block=block, link_to=link_to,
                                        out=out, replica=replica)

    def try_submit(self, op: str, lba: int = 0, data=None, blocks=None,
                   tenant: str | None = None, link_to=None, out=None,
                   replica: int = 0):
        """Non-blocking window probe: None when the tenant is at its
        in-flight bound (not counted as a failure), a ticket otherwise."""
        return self.aio_engine().try_submit(op, lba=lba, data=data,
                                            blocks=blocks, tenant=tenant,
                                            link_to=link_to, out=out,
                                            replica=replica)

    def register_buffers(self, n_buffers: int,
                         buf_bytes: int | None = None):
        """Register a zero-copy buffer pool on the volume's async engine
        (``buf_bytes`` defaults to the block size).  Returns the
        :class:`~repro_torch.volume.aio.BufferRegistry`."""
        return self.aio_engine().register_buffers(
            n_buffers, self.block_size if buf_bytes is None else buf_bytes)

    def poll(self, max_ops: int | None = None) -> list:
        """Drain the shared completion ring (empty when nothing was ever
        submitted)."""
        if self._aio is None:
            return []
        return self._aio.poll(max_ops)

    def wait(self, ticket, timeout: float | None = None):
        return self.aio_engine().wait(ticket, timeout=timeout)

    def max_atomic_write_blocks(self) -> int:
        """Largest ``write_multi`` the chained journal can commit
        atomically (ring bound: n_slots links of span blocks)."""
        return self.journal.max_chain_blocks()

    def flush(self) -> int:
        for d in self.shards:
            d.flush()
        return 0

    def fsync(self) -> int:
        """Group-committed durability point: concurrent callers coalesce
        behind one leader that drains every shard, persists the crc
        ledger, and checkpoints the journal in a single superblock pass
        (``commit_window`` gathers followers before committing)."""
        led = self._committer.sync()
        self.metrics.bump("group_commits" if led else "group_commit_waiters")
        return 0

    def _commit_group(self) -> None:
        with self._txlock:
            self._checkpoint_locked()

    def _checkpoint_locked(self, upto: int | None = None) -> None:
        for d in self.shards:
            d.fsync()
        upto = self.journal.last_txid() if upto is None else upto
        self.journal.mark_applied(upto)
        if self.cfg.persist_ledger:
            self._write_ledger()
        self._write_superblocks()

    # ------------------------------------------------------------- metadata
    def _write_ledger(self) -> None:
        """Persist the write-crc ledger into the reserved meta region
        (blocks striped round-robin over the shards), so a reopened
        volume verifies reads before its first overwrite.  The entry
        count + payload crc land in the superblock (written after this,
        so a torn ledger write is detected and ignored at load)."""
        items = list(self._crcs.items())
        bs = self.block_size
        cap = self.cfg.ledger_blocks_per_shard * self.cfg.n_shards \
            * (bs // _LEDGER_ENTRY_SIZE)
        if len(items) > cap:               # summary: persist what fits
            items = items[:cap]
        payload = b"".join(struct.pack(_LEDGER_ENTRY, lba, crc)
                           for lba, crc in items)
        self._ledger_count = len(items)
        self._ledger_crc = zlib.crc32(payload)
        per_block = (bs // _LEDGER_ENTRY_SIZE) * _LEDGER_ENTRY_SIZE
        n_blocks = -(-len(payload) // per_block) if payload else 0
        for j in range(n_blocks):
            chunk = payload[j * per_block:(j + 1) * per_block]
            chunk = chunk + b"\x00" * (bs - len(chunk))
            shard = j % self.cfg.n_shards
            local = 1 + j // self.cfg.n_shards
            assert local <= self.cfg.ledger_blocks_per_shard
            self.shards[shard].impl.btt.write(
                local, np.frombuffer(chunk, np.uint8))
        for d in self.shards:
            d.impl.btt.flush()

    def _load_ledger(self, count: int, crc: int) -> bool:
        """Rebuild the crc ledger from the meta region; False when the
        stored summary is absent or fails its own crc (torn write)."""
        if count <= 0:
            return False
        bs = self.block_size
        per_block = (bs // _LEDGER_ENTRY_SIZE) * _LEDGER_ENTRY_SIZE
        nbytes = count * _LEDGER_ENTRY_SIZE
        n_blocks = -(-nbytes // per_block)
        if n_blocks > self.cfg.ledger_blocks_per_shard * self.cfg.n_shards:
            return False
        chunks = []
        for j in range(n_blocks):
            shard = j % self.cfg.n_shards
            local = 1 + j // self.cfg.n_shards
            chunks.append(bytes(self.shards[shard].impl.btt.read(local))
                          [:per_block])
        payload = b"".join(chunks)[:nbytes]
        if zlib.crc32(payload) != crc:
            return False
        for off in range(0, nbytes, _LEDGER_ENTRY_SIZE):
            lba, c = struct.unpack_from(_LEDGER_ENTRY, payload, off)
            self._crcs[lba] = c
        self._ledger_count, self._ledger_crc = count, crc
        return True

    def _write_superblocks(self) -> None:
        for i, d in enumerate(self.shards):
            sb = self.cfg.to_sb(i, self.uuid,
                                applied_txid=self.journal.applied_txid)
            if self.cfg.persist_ledger:
                sb["ledger_count"] = self._ledger_count
                sb["ledger_crc"] = self._ledger_crc
            raw = json.dumps(sb).encode()
            raw = raw + b"\x00" * (self.block_size - len(raw))
            d.impl.btt.write(0, np.frombuffer(raw, np.uint8))
            d.impl.btt.flush()

    @staticmethod
    def read_superblock(dev) -> dict | None:
        raw = bytes(dev.impl.btt.read(0)).rstrip(b"\x00")
        if not raw:
            return None
        try:
            sb = json.loads(raw.decode())
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
        return sb if sb.get("magic") == _SB_MAGIC else None

    # ------------------------------------------------------------- recovery
    def recover(self) -> dict:
        """Replay the volume journal (per-shard Flog replay already happened
        when the shard devices were opened)."""
        records = self.journal.scan()
        for txid, lba, blocks in records:
            for i, blk in enumerate(blocks):
                if self.cfg.verify_reads:
                    self._crcs[lba + i] = zlib.crc32(blk)
                for r in range(self.cfg.replicas):
                    shard, local = self._map(lba + i, r)
                    self.shards[shard].impl.btt.write(
                        local, np.frombuffer(blk, np.uint8))
        last = max([t for t, _, _ in records],
                   default=self.journal.applied_txid)
        self.journal.next_txid = max(self.journal.next_txid, last + 1)
        self.journal.mark_applied(last)
        for d in self.shards:
            d.impl.btt.flush()
        if self.cfg.persist_ledger:
            self._write_ledger()       # replayed records refreshed crcs
        self._write_superblocks()
        stats = {
            "replayed_txs": len(records),
            "shards": [getattr(d.impl.btt, "recovery_stats", {})
                       for d in self.shards],
        }
        self.recovery_stats = stats
        return stats

    def scrub_replicas_detail(self, sample_every: int = 1) \
            -> list[tuple[int, int, int, int]]:
        """Compare every copy of every sampled block below the caches and
        return the DIVERGENT copies as (lba, replica, shard, local_lba)
        tuples — exactly what the resyncer needs to target repairs.  The
        bad copy is whichever disagrees with the trusted image (write-crc
        ledger, else majority/primary — see ``_pick_good_copy``)."""
        if self.cfg.replicas < 2:
            return []
        out = []
        for lba in range(0, self.n_lbas, sample_every):
            copies = []
            for r in range(self.cfg.replicas):
                shard, local = self._map(lba, r)
                copies.append((r, shard, local,
                               bytes(self.shards[shard].impl.btt.read(local))))
            datas = [c[3] for c in copies]
            if all(d == datas[0] for d in datas[1:]):
                continue
            good = self._pick_good_copy(lba, datas)
            if good is None:
                good = datas[0]     # nothing verifiable: primary wins
            out.extend((lba, r, shard, local)
                       for r, shard, local, d in copies if d != good)
        return out

    def scrub_replicas(self, sample_every: int = 1) -> int:
        """Count-compatible wrapper over :meth:`scrub_replicas_detail`."""
        return len(self.scrub_replicas_detail(sample_every))

    def scrub(self, sample_every: int = 1) -> dict:
        """Operator-facing scrub report: replica divergence plus the
        per-shard service-time EWMAs (``Metrics.per_node``) — the
        fail-slow signal a limping DIMM set shows long before it fails
        outright (one shard's EWMA drifting off its peers)."""
        detail = self.scrub_replicas_detail(sample_every)
        out = {"divergent": len(detail),
               "divergent_detail": detail,
               "per_shard_svc": self.metrics.per_node()}
        # tail-latency layer: refresh the scorer (installing steering
        # penalties as a side effect) and surface the verdicts + the
        # hedge counter balance
        states = self.refresh_tail_state()
        out["tail"] = {"states": states,
                       "shards": self.scorer.table(),
                       "hedge_delay_us": round(self.hedge_delay() * 1e6, 3),
                       **self.metrics.tail_path()}
        if self._aio is not None:
            s = self._aio.stats()
            out["zerocopy"] = {k: s[k] for k in (
                "copies_avoided", "bytes_pinned", "staging_copies",
                "staging_copy_bytes", "links_submitted", "link_cancelled",
                "link_depth_max")}
            if "registry" in s:
                out["zerocopy"]["registry"] = s["registry"]
        if self.autotuner is not None:
            out["autotune"] = self.autotuner.stats()
        return out

    # ---------------------------------------------------------------- stats
    def occupancy(self) -> float:
        if not self._caches:
            return 0.0
        return float(np.mean([d.occupancy() for d in self.shards]))

    def metrics_snapshot(self) -> dict:
        out = {"bypass_writes": 0, "bg_evictions": 0, "read_hits": 0,
               "read_misses": 0, "read_tier_hits": 0, "read_tier_fills": 0,
               "tier_fill_bypassed": 0}
        for d in self.shards:
            snap = d.metrics.snapshot()["count"]
            for k in out:
                out[k] += snap.get(k, 0)
        vol = self.metrics.snapshot()["count"]
        for k in ("verify_failures", "degraded_reads", "verify_races",
                  "unrecoverable_reads", "resync_repairs", "chain_txs",
                  "group_commits", "group_commit_waiters", "log_batches",
                  "log_batch_links", "log_batch_coalesced"):
            out[k] = vol.get(k, 0)
        out["journal_txs"] = self.journal.last_txid()
        out["applied_txid"] = self.journal.applied_txid
        out["chains_logged"] = self.journal.chains_logged
        out["group_commit"] = self._committer.stats()
        out["log_batcher"] = self._log_batcher.stats()
        if self._aio is not None:
            out["aio"] = self._aio.stats()
        out["admission"] = self.admission.stats()
        out["per_shard_svc"] = self.metrics.per_node()
        out["tail"] = {"states": self.scorer.states(),
                       **self.metrics.tail_path()}
        out["wfq_vbytes"] = self.metrics.per_tenant("wfq_vbytes")
        if self._gate is not None:
            out["wfq"] = self._gate.stats()
        if self.read_tier is not None:
            out["read_tier"] = self.read_tier.stats()
        if self.autotuner is not None:
            out["autotune"] = {**self.autotuner.stats(),
                               **self.metrics.autotune_path()}
        return out

    def close(self) -> None:
        if self._aio is not None:
            self._aio.close()        # drain in-flight tickets first
        self.fsync()
        if self.resyncer is not None:
            self.resyncer.close()
        for d in self.shards:
            d.close()
        if self.pool is not None:
            self.pool.close()


def make_volume(policy: str = "caiti", *, n_lbas: int, n_shards: int = 4,
                stripe_blocks: int = 64, replicas: int = 1,
                block_size: int = 4096, cache_bytes: int = 64 << 20,
                shared_workers: int = 4, bypass_watermark: float = 0.9,
                journal_slots: int = 64, journal_span: int = 8,
                backend: str = "ram", path: str | None = None,
                latency: LatencyModel | None = None,
                tenants: list[TenantSpec] | None = None,
                nfree: int | None = None,
                max_inflight: int = 16, read_tier_bytes: int = 0,
                n_sockets: int = 1,
                verify_reads: bool | None = None,
                commit_window: float = 0.0,
                log_window: float = 0.0,
                scan_threshold: int = 64,
                tier_hit_cost_frac: float = 0.125,
                persist_ledger: bool = True,
                aio_workers: int = 2,
                hedge_delay_us: float = 0.0,
                autotune: Controller | bool | None = None) -> StripedVolume:
    """Build (or reopen + recover) a striped volume.

    ``path`` is a prefix for file-backed shards (``{path}.shard{i}``); a
    prefix whose shard files already carry volume superblocks is RECOVERED
    (per-shard Flog replay + volume journal replay), not re-formatted.

    ``read_tier_bytes > 0`` puts one shared clean DRAM read tier in front
    of all shards (caiti policies).  ``n_sockets > 1`` splits the shared
    eviction pool into per-socket worker banks and pins shard *i* to
    socket ``i % n_sockets`` (the socket owning its PMem DIMM set).

    NOTE: the crc-ledger meta region (``persist_ledger``, on by default
    for replicated volumes) changes the on-media geometry.  A replicated
    volume formatted BEFORE the ledger existed must be reopened with
    ``persist_ledger=False`` — the geometry check rejects the mismatch
    rather than silently misplacing the journal/data regions.
    """
    cfg = VolumeConfig(n_lbas=n_lbas, n_shards=n_shards,
                       stripe_blocks=stripe_blocks, replicas=replicas,
                       policy=policy, block_size=block_size,
                       cache_bytes=cache_bytes, shared_workers=shared_workers,
                       bypass_watermark=bypass_watermark,
                       journal_slots=journal_slots, journal_span=journal_span,
                       max_inflight=max_inflight,
                       read_tier_bytes=read_tier_bytes, n_sockets=n_sockets,
                       verify_reads=verify_reads,
                       commit_window=commit_window,
                       log_window=log_window,
                       scan_threshold=scan_threshold,
                       tier_hit_cost_frac=tier_hit_cost_frac,
                       persist_ledger=persist_ledger,
                       aio_workers=aio_workers,
                       hedge_delay_us=hedge_delay_us)
    paths = [None] * n_shards
    if backend == "file":
        assert path is not None, "file backend needs a path prefix"
        paths = [f"{path}.shard{i}" for i in range(n_shards)]
    pool = SharedEvictionPool(shared_workers, name="vol",
                              n_sockets=n_sockets) \
        if policy.startswith("caiti") else None
    tier = ReadTier(read_tier_bytes, block_size) \
        if read_tier_bytes > 0 and policy.startswith("caiti") else None
    shards = []
    per_shard_cache = max(block_size, cache_bytes // n_shards)
    for i in range(n_shards):
        shards.append(make_device(
            policy, n_lbas=cfg.shard_n_lbas, block_size=block_size,
            cache_bytes=per_shard_cache, backend=backend, path=paths[i],
            latency=latency, nfree=nfree, evict_pool=pool,
            read_tier=tier, tier_ns=i))
        if pool is not None:
            pool.assign_socket(shards[-1].impl, i % max(1, n_sockets))

    sbs = [StripedVolume.read_superblock(d) for d in shards]
    existing = all(sb is not None for sb in sbs)
    # a PARTIAL member set is a damaged volume, never a fresh one:
    # re-formatting would silently orphan the surviving shards' data
    assert existing or not any(sb is not None for sb in sbs), \
        "volume member missing/damaged: shards without superblock " \
        f"{[i for i, sb in enumerate(sbs) if sb is None]}"
    if existing:
        # geometry + membership must agree before we trust the stripes
        uuids = {sb["uuid"] for sb in sbs}
        assert len(uuids) == 1, f"mixed volumes: {uuids}"
        for i, sb in enumerate(sbs):
            assert sb["shard"] == i, f"shard {i} holds member {sb['shard']}"
            want = cfg.to_sb(i, sb["uuid"])
            mismatch = [k for k in ("n_shards", "n_lbas", "stripe_blocks",
                                    "replicas", "journal_slots",
                                    "journal_span", "ledger_blocks")
                        if sb.get(k, 0) != want[k]]
            assert not mismatch, \
                f"geometry mismatch on shard {i}: {mismatch}"
        vol = StripedVolume(shards, cfg, uuid=sbs[0]["uuid"], evict_pool=pool,
                            read_tier=tier)
        vol.journal.applied_txid = max(sb.get("applied_txid", 0)
                                       for sb in sbs)
        vol.journal.next_txid = vol.journal.applied_txid + 1
        if cfg.persist_ledger:
            # newest checkpoint wins: the shard sb with the highest
            # applied mark carries the matching ledger summary
            newest = max(sbs, key=lambda s: s.get("applied_txid", 0))
            vol._load_ledger(newest.get("ledger_count", 0),
                             newest.get("ledger_crc", 0))
        vol.recover()
    else:
        uuid = os.urandom(8).hex()
        vol = StripedVolume(shards, cfg, uuid=uuid, evict_pool=pool,
                            read_tier=tier)
        vol._write_superblocks()
    for t in (tenants or []):
        vol.add_tenant(t.name, weight=t.weight, rate_mbps=t.rate_mbps,
                       burst_bytes=t.burst_bytes)
    # self-tuning control plane: autotune=True attaches the stock
    # controller, a Controller instance attaches that one; None/False
    # leaves every knob frozen at its configured value
    if autotune:
        vol.attach_autotuner(None if autotune is True else autotune)
    return vol
