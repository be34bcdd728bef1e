"""repro_torch.volume — striped multi-device volume manager over PMem shards.

Generalizes the paper's single-device Caiti mechanism to a logical volume:

    make_volume(...)       — N-shard RAID-0 (optionally replicated) volume
    StripedVolume          — the volume manager itself
    VolumeConfig           — geometry + policy knobs
    SharedEvictionPool     — one background eviction pool drained
                             congestion-aware across all shards, in
                             per-socket (NUMA) worker banks
    VolumeJournal          — chained-tx redo journal: whole-object
                             all-or-nothing crash semantics for logical
                             writes of any size (tail header = commit pt)
    GroupCommitter         — leader/follower fsync coalescing (one drain
                             + superblock pass per concurrent batch)
    AdmissionPolicy        — unified admission: bypass watermark, read-
                             tier fill policy (sequential-scan bypass),
                             tier-aware QoS read pricing
    ScanDetector           — multi-stream sequential-run tracker
    ReadTier               — clean-slot CLOCK DRAM read cache fronting the
                             shards (never journaled)
    ReplicaResyncer        — background repair of divergent replica blocks
    TokenBucket, WFQGate   — per-tenant QoS (rate limits + weighted fair
                             scheduling)
    TenantSpec             — declarative tenant weight/rate description
    AsyncIOEngine, Ticket  — io_uring-style submission/completion
                             frontend (``StripedVolume.submit/poll``):
                             per-tenant SQs, shared completion ring,
                             bounded in-flight backpressure, per-ticket
                             failure isolation, IO_LINK ticket chains
    BufferRegistry         — registered zero-copy buffer pool: pinned
                             payloads instead of staging copies, with
                             copy-on-evict when a slot is reused early
    Controller, Knob       — self-tuning control plane: bounded
                             AIMD-style feedback over commit/log
                             windows, bypass watermark, scan threshold
                             and hedge delay, gated by hysteresis and
                             hard clamps (``attach_autotuner`` /
                             ``make_volume(autotune=True)``)

The read path (layered, new in PR 2)
------------------------------------
The paper's transit cache is write-only by design (§4.3.2: never allocate
a slot on a read miss), so every layer of the read path is stacked in
front of it instead of inside it.  A ``StripedVolume.read(lba)`` walks:

    1. **transit cache** — staged writes not yet evicted (newest data);
    2. **ReadTier** — one shared clean DRAM tier for all shards, keyed
       ``(shard, local_lba)``; populated on read miss and on eviction
       writeback, invalidated (fenced) by writes.  Clean slots only: the
       tier is never journaled and costs nothing at flush/crash time;
    3. **primary shard BTT** — the PMem media read;
    4. **verification** — with ``replicas > 1`` the result is checked
       against the write-time crc ledger; a failing primary falls back to
    5. **replica shard** (degraded read) — the verified replica copy is
       served, read-repaired into the tier under the primary's key, and
       the block is queued to the ``ReplicaResyncer``, which rewrites bad
       copies through atomic BTT writes on the shared eviction cores.

Writes are unchanged from the paper (stage -> eager eviction -> BTT,
conditional bypass under pressure); they only *invalidate* tier entries,
so crash atomicity (redo journal + BTT Flog) is untouched by the tier.
"""
from .admission import AdmissionPolicy, ScanDetector
from .autotune import (Controller, Knob, default_knobs,
                       make_default_controller)
from .aio import (AsyncIOEngine, BackpressureError, BufferRegistry,
                  CancelledError, LinkCancelledError, RegisteredBuf,
                  SubmitError, Ticket, TicketError)
from .evict_pool import SharedEvictionPool
from .journal import GroupCommitter, LogBatcher, LogEntry, VolumeJournal
from .qos import QoSError, TenantSpec, TokenBucket, WFQGate
from .read_tier import ReadTier, ReplicaResyncer
from .volume import StripedVolume, VolumeConfig, make_volume

__all__ = [
    "SharedEvictionPool", "VolumeJournal", "GroupCommitter", "LogBatcher",
    "LogEntry", "TokenBucket", "WFQGate", "TenantSpec", "QoSError",
    "StripedVolume", "VolumeConfig", "make_volume", "ReadTier",
    "ReplicaResyncer", "AdmissionPolicy", "ScanDetector",
    "AsyncIOEngine", "Ticket", "TicketError", "SubmitError",
    "BackpressureError", "CancelledError", "LinkCancelledError",
    "BufferRegistry", "RegisteredBuf",
    "Controller", "Knob", "default_knobs", "make_default_controller",
]
