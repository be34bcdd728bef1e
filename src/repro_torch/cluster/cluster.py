"""ClusterVolume: chain-replicated block volume over networked nodes.

The distributed sibling of :class:`repro_torch.volume.StripedVolume` — same
convenience surface (``write`` / ``write_multi`` / ``read`` / ``fsync``
/ ``flush`` plus the async ``submit`` / ``poll`` / ``wait`` frontend),
but the unit of redundancy is a **node**, not a shard:

  * the LBA space is carved into chunks; each chunk's
    :class:`~repro_torch.cluster.placement.PlacementPolicy` chain is its write
    pipeline (primary first, K members, rack-spread);
  * a logical write is **pipelined down the chain**: the payload is
    delivered to each member's :class:`~repro_torch.cluster.node.NetLink` and
    landed through that node's own ``StripedVolume`` —
    ``write_multi`` there, so every hop commits the object through its
    chained-tx journal (per-node whole-object atomicity).  The write is
    ACKED only after all K durable tails landed;
  * the cluster keeps its own write-crc **ledger updated at ack time
    only**: a write that died mid-pipeline (node killed between hops)
    leaves the ledger on the OLD version, so verified reads fail over
    past the torn copies and keep serving the old object — acknowledged
    writes are never lost, unacknowledged ones never tear;
  * **crc-degraded reads**: a copy failing ledger verification (or a
    dead/partitioned member) fails over down the chain; if every live
    copy agrees and only the ledger disagrees it is a mid-flight write,
    served quietly (``verify_races``) — the same arbitration ladder as
    ``StripedVolume._read_verified``, one level up;
  * the :class:`ReReplicator` (cluster-scale sibling of
    ``ReplicaResyncer``) watches the :class:`HeartbeatMonitor`, declares
    stale nodes dead, and regenerates every affected chunk onto a
    placement-chosen survivor — optionally riding the shared eviction
    pool through the same participant interface;
  * **every pipeline step is observable**: ``step_hook`` fires before
    each transfer/write/ack step with the node involved, so the crash
    sweep in ``tests/aio_harness.py`` can kill the node at step N for
    every N — "no acked write is ever lost" becomes a swept property.

The async frontend is the *existing* ``AsyncIOEngine`` verbatim: it
works over anything speaking write/write_multi/read/fsync/flush, so a
node death during an async op fails THAT ticket (per-ticket isolation)
and never the ring.
"""
from __future__ import annotations

import threading
import time
import zlib

import numpy as np

from repro_torch.core.metrics import Metrics, ShardScorer
from repro_torch.volume import TenantSpec, make_volume
from repro_torch.volume.aio import (AsyncIOEngine, RegisteredBuf,
                              hedged_read as _hedged_read)

from .node import (ClusterError, ClusterNode, ClusterUnavailableError,
                   HeartbeatMonitor, NetLink, NodeDownError)
from .placement import NodeInfo, PlacementPolicy


class ClusterConfig:
    """Geometry + policy for a cluster volume (blocks of ``block_size``;
    ``chunk_blocks`` is the placement/replication unit)."""

    def __init__(self, *, n_lbas: int, replication_k: int = 2,
                 chunk_blocks: int = 64, block_size: int = 4096,
                 heartbeat_timeout: float = 5.0,
                 max_inflight: int = 16, aio_workers: int = 2,
                 hedge_delay_us: float = 0.0) -> None:
        assert n_lbas >= 1 and chunk_blocks >= 1 and replication_k >= 1
        self.n_lbas = n_lbas
        self.replication_k = replication_k
        self.chunk_blocks = chunk_blocks
        self.block_size = block_size
        self.heartbeat_timeout = heartbeat_timeout
        self.max_inflight = max_inflight
        self.aio_workers = aio_workers
        # hedged chain reads: wait this long on the primary before the
        # next chain member (0 = auto: healthy-cohort median p99)
        self.hedge_delay_us = hedge_delay_us

    @property
    def n_chunks(self) -> int:
        return -(-self.n_lbas // self.chunk_blocks)


class ClusterVolume:
    """The logical distributed device (see module docstring)."""

    #: single-chunk ``write_multi`` is whole-object atomic on every
    #: chain member (per-node chained-tx journal) and acked only when
    #: all K durable tails landed
    supports_chained_tx = True

    def __init__(self, nodes: list[ClusterNode], cfg: ClusterConfig, *,
                 placement: PlacementPolicy, now_fn=None,
                 evict_pool=None) -> None:
        self.nodes = list(nodes)
        self.cfg = cfg
        self.placement = placement
        self.block_size = cfg.block_size
        self.n_lbas = cfg.n_lbas
        self._now = now_fn or time.monotonic
        self.metrics = Metrics()
        # fail-slow scoring: per-node p50/p99 digests over svc::node{i}
        # (hedged chain reads + placement steering consume the verdicts)
        self.scorer = ShardScorer(self.metrics, family="node")
        # cluster write-crc ledger — updated at ACK only (see module doc)
        self._crcs: dict[int, int] = {}
        self._chains: dict[int, list[int]] = {}
        self._lock = threading.Lock()
        self.monitor = HeartbeatMonitor(self.nodes,
                                        timeout=cfg.heartbeat_timeout,
                                        now_fn=self._now)
        self.rereplicator = ReReplicator(self, pool=evict_pool)
        # crash-sweep instrumentation: hook(step_no, phase, node_idx)
        # fires BEFORE each pipeline step ('xfer' | 'write' | 'ack')
        self.step_hook = None
        self._step_no = 0
        self._aio: AsyncIOEngine | None = None
        # self-tuning control plane (attach_autotuner): None = frozen
        self.autotuner = None

    # -------------------------------------------------------------- mapping
    def _chain_for(self, chunk: int) -> list[int]:
        with self._lock:
            chain = self._chains.get(chunk)
            if chain is None:
                alive = [n.idx for n in self.nodes if n.alive]
                chain = self.placement.assign(chunk, self.cfg.chunk_blocks,
                                              eligible=alive or None)
                self._chains[chunk] = chain
            return chain

    @staticmethod
    def _crc(data) -> int:
        if isinstance(data, (bytes, bytearray, memoryview)):
            return zlib.crc32(data)
        return zlib.crc32(np.ascontiguousarray(data, dtype=np.uint8))

    def _step(self, phase: str, node_idx: int) -> None:
        self._step_no += 1
        if self.step_hook is not None:
            self.step_hook(self._step_no, phase, node_idx)

    # ------------------------------------------------------------------ QoS
    def add_tenant(self, name: str, weight: float = 1.0,
                   rate_mbps: float = 0.0,
                   burst_bytes: int = 4 << 20) -> None:
        """Tenant QoS applies on every member volume (each node runs its
        own WFQ gate + token bucket over its local media)."""
        for n in self.nodes:
            n.volume.add_tenant(name, weight=weight, rate_mbps=rate_mbps,
                                burst_bytes=burst_bytes)

    # ------------------------------------------------------------------ I/O
    def write(self, lba: int, data, tenant: str | None = None) -> int:
        return self.write_multi(lba, [data], tenant=tenant)

    def write_multi(self, lba: int, blocks, tenant: str | None = None) -> int:
        """Pipelined chain-replicated logical write.  Within one chunk
        the write is whole-object atomic end to end (every member lands
        it through its chained-tx journal; the ack — and the cluster
        ledger update — happen only after all K durable tails).  A write
        spanning chunks commits chunk group by chunk group, each group
        atomic on its own chain.  :class:`RegisteredBuf` handles are
        accepted anywhere a block is (the same zero-copy surface the
        async engine pins — one code path for pooled callers)."""
        blocks = [b.data if isinstance(b, RegisteredBuf) else b
                  for b in blocks]
        assert blocks, "empty write"
        assert 0 <= lba and lba + len(blocks) <= self.n_lbas, \
            f"write [{lba}, {lba + len(blocks)}) out of volume range"
        cb = self.cfg.chunk_blocks
        i = 0
        while i < len(blocks):
            start = lba + i
            room = cb - (start % cb)
            n = min(room, len(blocks) - i)
            self._write_chain(start, blocks[i:i + n], tenant)
            i += n
        return 0

    def _write_chain(self, lba: int, blocks, tenant) -> None:
        """One chunk-local write down its chain: xfer + durable write per
        hop, ack (and ledger update) last.  Any hop failing — node down,
        partition, device error — aborts BEFORE the ack: the cluster
        ledger keeps the old crcs, so verified reads resolve the torn
        copies back to the old version."""
        chain = self._chain_for(lba // self.cfg.chunk_blocks)
        nbytes = len(blocks) * self.block_size
        for ni in chain:
            node = self.nodes[ni]
            self._step("xfer", ni)
            node.deliver(nbytes, self._now())
            self._step("write", ni)
            if not node.alive:          # killed between transfer and write
                raise NodeDownError(f"node {node.name} died mid-pipeline")
            t0 = time.perf_counter_ns()
            if len(blocks) == 1:
                node.volume.write(lba, blocks[0], tenant=tenant)
            else:
                node.volume.write_multi(lba, blocks, tenant=tenant)
            dt = time.perf_counter_ns() - t0
            self.metrics.observe(f"svc::node{ni}", dt)
            self.placement.observe_load(ni, dt / 1e3)
        self._step("ack", chain[0])
        for i, b in enumerate(blocks):
            self._crcs[lba + i] = self._crc(b)
        self.metrics.bump("acked_writes")
        self.metrics.bump("acked_blocks", len(blocks))

    def read(self, lba: int, out: np.ndarray | None = None,
             tenant: str | None = None, replica: int = 0) -> np.ndarray:
        """Verified chain read with failover: walk the chain from the
        primary; a dead/partitioned member or a copy failing the cluster
        ledger crc fails over to the next.  Arbitration when nothing
        verifies mirrors ``StripedVolume._read_verified``: all live
        copies agreeing means a mid-flight write (serve quietly);
        otherwise surface the primary-most copy and count it.
        ``replica=`` rotates the walk to start at that chain position —
        the hedge path's backup leg reads the NEXT member first (the
        full failover ladder is preserved)."""
        assert 0 <= lba < self.n_lbas
        chain = self._chain_for(lba // self.cfg.chunk_blocks)
        if replica:
            r = replica % len(chain)
            chain = chain[r:] + chain[:r]
        want = self._crcs.get(lba)
        candidates: list[bytes] = []
        for pos, ni in enumerate(chain):
            node = self.nodes[ni]
            try:
                node.deliver(self.block_size, self._now())
            except ClusterError:
                self.metrics.bump("read_failovers")
                continue
            t0 = time.perf_counter_ns()
            data = node.volume.read(lba, tenant=tenant)
            dt = time.perf_counter_ns() - t0
            self.metrics.observe(f"svc::node{ni}", dt)
            self.placement.observe_load(ni, dt / 1e3)
            if want is None or self._crc(data) == want:
                if pos > 0 or candidates:
                    self.metrics.bump("degraded_reads")
                return self._fill(out, data)
            self.metrics.bump("verify_failures")
            candidates.append(bytes(data))
        if candidates:
            if all(c == candidates[0] for c in candidates):
                self.metrics.bump("verify_races")
            else:
                self.metrics.bump("unrecoverable_reads")
            return self._fill(out, np.frombuffer(candidates[0], np.uint8))
        raise ClusterUnavailableError(
            f"no live replica for lba {lba} (chain {chain})")

    @staticmethod
    def _fill(out, data):
        if out is not None:
            out[:] = data
            return out
        return data

    # ----------------------------------------------------------- tail latency
    def refresh_tail_state(self) -> dict:
        """Recompute the per-node healthy/limping/dead verdicts (dead
        nodes are marked by the failure detector) and push the penalties
        into placement scoring, so new chains route around a limping
        node before it ever misses a heartbeat.  Returns the state
        map."""
        for n in self.nodes:
            if not n.alive:
                self.scorer.mark_dead(f"node{n.idx}")
        states = self.scorer.states()
        pens: dict[int, float] = {}
        for member in states:
            if member.startswith("node"):
                try:
                    idx = int(member[4:])
                except ValueError:
                    continue
                pens[idx] = self.scorer.penalty(member)
        before = self.placement.steered_placements
        self.placement.set_penalties(pens)
        delta = self.placement.steered_placements - before
        if delta:
            self.metrics.bump("steered_placements", delta)
        return states

    def hedge_delay(self) -> float:
        """Seconds to wait on the chain primary before hedging to the
        next member (``hedge_delay_us`` or auto from the scorer)."""
        us = self.cfg.hedge_delay_us
        if us <= 0:
            us = self.scorer.hedge_delay_us(default_us=1000.0)
        return max(us, 1.0) / 1e6

    def hedged_read(self, lba: int, out=None, tenant: str | None = None,
                    delay_s: float | None = None):
        """Tail-tolerant chain read: primary first; after one hedge
        delay the NEXT chain member races it, first completion wins and
        the loser is cancelled (same contract as
        ``StripedVolume.hedged_read`` — counters balance in
        ``Metrics.tail_path()``).  Single-copy chains fall back to a
        plain :meth:`read`."""
        if min(self.cfg.replication_k, len(self.nodes)) < 2:
            return self.read(lba, out=out, tenant=tenant)
        delay = self.hedge_delay() if delay_s is None else delay_s
        return _hedged_read(self, lba, delay_s=delay, out=out,
                            tenant=tenant)

    def flush(self) -> int:
        for n in self.nodes:
            if n.alive and not n.partitioned:
                n.volume.flush()
        return 0

    def fsync(self) -> int:
        """Durability point on every reachable member (each node runs
        its own group-committed checkpoint)."""
        for n in self.nodes:
            if n.alive and not n.partitioned:
                n.volume.fsync()
        self.metrics.bump("cluster_fsyncs")
        return 0

    def max_atomic_write_blocks(self) -> int:
        """Largest whole-object-atomic ``write_multi``: bounded by the
        chunk (a chain never splits an object) and by every member
        journal's ring."""
        node_max = min(n.volume.max_atomic_write_blocks()
                       for n in self.nodes)
        return min(node_max, self.cfg.chunk_blocks)

    # --------------------------------------------------------- async frontend
    def aio_engine(self, *, n_workers: int | None = None,
                   max_inflight_per_tenant: int | None = None) \
            -> AsyncIOEngine:
        """The cluster's :class:`~repro_torch.volume.aio.AsyncIOEngine` —
        the SAME engine the striped volume uses (it speaks the shared
        write/write_multi/read/fsync/flush surface), so per-ticket
        failure isolation extends to node deaths: a chain losing a
        member mid-op fails that ticket with :class:`NodeDownError`,
        never the ring.  Same first-call-configures contract as
        ``StripedVolume.aio_engine``."""
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
                "aio engine already running a different worker count"
            assert max_inflight_per_tenant is None \
                or max_inflight_per_tenant \
                == self._aio.max_inflight_per_tenant, \
                "aio engine already running a different in-flight bound"
        return self._aio

    def submit(self, op: str, lba: int = 0, data=None, blocks=None,
               tenant: str | None = None, block: bool = False,
               link_to=None, out=None, replica: int = 0):
        return self.aio_engine().submit(op, lba=lba, data=data,
                                        blocks=blocks, tenant=tenant,
                                        block=block, link_to=link_to,
                                        out=out, replica=replica)

    def try_submit(self, op: str, lba: int = 0, data=None, blocks=None,
                   tenant: str | None = None, link_to=None, out=None,
                   replica: int = 0):
        return self.aio_engine().try_submit(op, lba=lba, data=data,
                                            blocks=blocks, tenant=tenant,
                                            link_to=link_to, out=out,
                                            replica=replica)

    def register_buffers(self, n_buffers: int,
                         buf_bytes: int | None = None):
        """Registered zero-copy buffer pool on the cluster's engine
        (same contract as ``StripedVolume.register_buffers``)."""
        return self.aio_engine().register_buffers(
            n_buffers, self.block_size if buf_bytes is None else buf_bytes)

    def poll(self, max_ops: int | None = None) -> list:
        if self._aio is None:
            return []
        return self._aio.poll(max_ops)

    def wait(self, ticket, timeout: float | None = None):
        return self.aio_engine().wait(ticket, timeout=timeout)

    # ------------------------------------------------------------- liveness
    def kill_node(self, idx: int) -> None:
        """Fail-stop ``idx`` (test/ops hook): deliveries start raising;
        detection still goes through the heartbeat channel."""
        self.nodes[idx].kill()

    def partition_node(self, idx: int, flag: bool = True) -> None:
        self.nodes[idx].partition(flag)

    def heartbeat_tick(self, now: float | None = None) -> None:
        """One heartbeat exchange (reachable nodes beat)."""
        self.monitor.tick(now)

    def resync(self, sample_every: int = 1) -> int:
        """Repair cross-node divergence (partition-heal convergence):
        rewrite every sampled ledger'd block whose copy disagrees with
        the cluster crc from a verified sibling."""
        return self.rereplicator.repair_divergent(sample_every)

    # --------------------------------------------------------- control plane
    def attach_autotuner(self, controller=None):
        """Attach a self-tuning controller at CLUSTER scope: the hedge
        delay is tuned from the node scorer's verdicts, and every other
        knob move (commit/log windows, watermark, scan threshold) fans
        out to each live member's :class:`StripedVolume`, so one control
        loop retunes the whole fleet coherently."""
        if controller is None:
            from repro_torch.volume.autotune import make_default_controller
            controller = make_default_controller()
        member = self.nodes[0].volume
        seed = {"commit_window_us": member.cfg.commit_window * 1e6,
                "log_window_us": member.cfg.log_window * 1e6,
                "bypass_watermark": member.cfg.bypass_watermark,
                "scan_threshold": float(member.cfg.scan_threshold)}
        if self.cfg.hedge_delay_us > 0:
            seed["hedge_delay_us"] = self.cfg.hedge_delay_us
        controller.bind(seed)
        self.autotuner = controller
        return controller

    def autotune_signals(self) -> dict:
        """Fleet-wide signal window: member volumes' windows aggregated
        ops-weighted, with the tail verdicts replaced by the CLUSTER
        scorer's (a limping node, not a limping shard, is what the
        cluster hedge trigger must track)."""
        members = [n.volume.autotune_signals() for n in self.nodes
                   if n.alive]
        agg: dict = {"ops": sum(s["ops"] for s in members)}
        total = max(1, agg["ops"])
        for key in ("fsync_rate", "coalesce_rate", "log_rate",
                    "log_coalesce_rate", "stall_rate", "bypass_rate",
                    "staged_frac", "read_rate", "tier_hit_rate",
                    "scan_denial_rate"):
            agg[key] = sum(s.get(key, 0.0) * max(1, s["ops"])
                           for s in members) / total
        states = self.scorer.states()
        agg["limping"] = any(s != "healthy" for s in states.values())
        agg["healthy_p99_us"] = self.scorer.hedge_delay_us(default_us=0.0)
        return agg

    def autotune_step(self) -> dict:
        """One cluster control tick (see :meth:`attach_autotuner`)."""
        if self.autotuner is None:
            return {}
        changes = self.autotuner.observe(self.autotune_signals())
        if changes:
            if "hedge_delay_us" in changes:
                self.cfg.hedge_delay_us = changes["hedge_delay_us"]
            member_changes = {k: v for k, v in changes.items()
                              if k != "hedge_delay_us"}
            if member_changes:
                for n in self.nodes:
                    if n.alive:
                        n.volume._apply_knobs(member_changes)
            self.metrics.bump("autotune_moves", len(changes))
            for name in changes:
                self.metrics.bump(f"autotune_moves::{name}")
        self.metrics.bump("autotune_ticks")
        return changes

    # ---------------------------------------------------------------- stats
    def scrub(self, sample_every: int = 1) -> dict:
        """Operator scrub: replication health per chunk, cross-node
        divergence against the cluster ledger, the per-node service-time
        EWMAs (``Metrics.per_node`` — the fail-slow signal) and link
        accounting."""
        want_k = min(self.cfg.replication_k, len(self.nodes))
        under = []
        divergent = 0
        with self._lock:
            chains = dict(self._chains)
        for chunk, chain in sorted(chains.items()):
            live = [ni for ni in chain if self.nodes[ni].alive]
            if len(live) < want_k:
                under.append(chunk)
            base = chunk * self.cfg.chunk_blocks
            top = min(base + self.cfg.chunk_blocks, self.n_lbas)
            for lba in range(base, top, sample_every):
                want = self._crcs.get(lba)
                if want is None:
                    continue
                for ni in live:
                    node = self.nodes[ni]
                    if node.partitioned:
                        continue
                    if self._crc(node.volume.read(lba)) != want:
                        divergent += 1
        states = self.refresh_tail_state()
        return {
            "chunks": len(chains),
            "under_replicated": under,
            "divergent_blocks": divergent,
            "per_node": self.metrics.per_node(),
            "tail": {"states": states,
                     "nodes": self.scorer.table(),
                     "hedge_delay_us": round(self.hedge_delay() * 1e6, 3),
                     **self.metrics.tail_path()},
            "placement": self.placement.stats(),
            "nodes": [{"name": n.name, "rack": n.rack, "alive": n.alive,
                       "partitioned": n.partitioned,
                       "link": n.link.stats()} for n in self.nodes],
        }

    def metrics_snapshot(self) -> dict:
        out = dict(self.metrics.snapshot()["count"])
        out["per_node_svc"] = self.metrics.per_node()
        out["tail"] = {"states": self.scorer.states(),
                       **self.metrics.tail_path()}
        out["chunks_mapped"] = len(self._chains)
        if self._aio is not None:
            out["aio"] = self._aio.stats()
        if self.autotuner is not None:
            out["autotune"] = self.autotuner.stats()
        return out

    def close(self) -> None:
        if self._aio is not None:
            self._aio.close()
        self.rereplicator.close()
        for n in self.nodes:
            n.close()


class ReReplicator:
    """Cluster-scale sibling of ``ReplicaResyncer``: heartbeat-driven
    death detection + chunk regeneration onto survivors.

    ``run_once`` is the deterministic entry point (tests, the quickstart
    and the benches drive it with a manual clock): tick the heartbeat
    exchange, declare stale nodes dead, then repair every chain that
    lost a member — placement picks the target, the surviving copy that
    matches the cluster ledger sources the blocks, and the chain entry
    is swapped so future I/O uses the regenerated copy.

    With ``pool`` given, repairs ride the shared eviction pool through
    the SAME participant interface a shard cache exposes
    (``_evict_slot`` / ``_complete_eviction``): re-replication storms
    share the background cores with eviction traffic instead of
    spawning their own."""

    def __init__(self, cluster: ClusterVolume, *, pool=None,
                 socket: int = 0) -> None:
        self.cluster = cluster
        self.pool = pool
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queued: set[tuple[int, int]] = set()   # (chunk, dead_node)
        self._inflight = 0
        self._stop = False
        self.declared_dead: list[int] = []
        if pool is not None:
            pool.register(self, socket=socket)

    # ------------------------------------------------------------ detection
    def detect(self, now: float | None = None) -> list[int]:
        """One failure-detector round: heartbeat exchange, then declare
        every stale node dead (fail-stop from the cluster's point of
        view — a partitioned node past the timeout is declared too,
        HDFS-style; if it ever heals it must rejoin as a new member)."""
        cl = self.cluster
        cl.monitor.tick(now)
        newly = []
        for ni in cl.monitor.check(now):
            node = cl.nodes[ni]
            if node.alive:
                node.kill()
            if ni not in self.declared_dead:
                self.declared_dead.append(ni)
                newly.append(ni)
                cl.metrics.bump("dead_nodes_declared")
                # fail-stop is the terminal fail-slow state: the scorer
                # pins the node 'dead' so steering penalties survive
                # even after its service samples age out
                cl.scorer.mark_dead(f"node{ni}")
        return newly

    # --------------------------------------------------------------- repair
    def run_once(self, now: float | None = None) -> dict:
        """Detect + synchronously repair every under-replicated chain.
        Returns the storm's accounting."""
        newly = self.detect(now)
        cl = self.cluster
        stats = {"declared_dead": newly, "chunks_repaired": 0,
                 "blocks_copied": 0, "unplaceable": 0}
        with cl._lock:
            chains = list(cl._chains.items())
        for chunk, chain in chains:
            for dead in [ni for ni in chain if not cl.nodes[ni].alive]:
                copied = self._repair_chunk(chunk, dead)
                if copied is None:
                    stats["unplaceable"] += 1
                else:
                    stats["chunks_repaired"] += 1
                    stats["blocks_copied"] += copied
        return stats

    def request(self, chunk: int, dead: int) -> bool:
        """Queue one chunk repair on the shared pool (deduplicated)."""
        job = (chunk, dead)
        with self._cond:
            if self._stop or self.pool is None or job in self._queued:
                return False
            self._queued.add(job)
            self._inflight += 1
            self.pool.submit(self, job)
        return True

    def wait_idle(self, timeout: float = 30.0) -> bool:
        with self._cond:
            return self._cond.wait_for(lambda: self._inflight == 0,
                                       timeout=timeout)

    # ----------------------------------------- pool-participant interface
    def _evict_slot(self, job: tuple[int, int]) -> None:
        try:
            self._repair_chunk(*job)
        finally:
            with self._cond:
                self._queued.discard(job)

    def _complete_eviction(self, n: int = 1) -> None:
        with self._cond:
            self._inflight -= n
            self._cond.notify_all()

    def _repair_chunk(self, chunk: int, dead: int) -> int | None:
        """Regenerate ``dead``'s copy of ``chunk`` onto a placement-
        chosen survivor.  Only ledger'd (ever-acked) blocks move — the
        copy that matches the cluster crc sources each one.  Returns
        blocks copied, or None when no target exists (the chain stays
        under-replicated and keeps showing up in ``scrub``)."""
        cl = self.cluster
        chain = cl._chains.get(chunk)
        if chain is None or dead not in chain:
            return 0
        alive = [n.idx for n in cl.nodes if n.alive and not n.partitioned]
        target = cl.placement.replacement(chain, dead, alive)
        if target is None:
            cl.metrics.bump("rereplication_unplaceable")
            return None
        tnode = cl.nodes[target]
        base = chunk * cl.cfg.chunk_blocks
        top = min(base + cl.cfg.chunk_blocks, cl.n_lbas)
        copied = 0
        for lba in range(base, top):
            want = cl._crcs.get(lba)
            if want is None:
                continue                      # never acked: nothing to move
            data = None
            for ni in chain:
                if ni == dead or ni not in alive:
                    continue
                got = cl.nodes[ni].volume.read(lba)
                if cl._crc(got) == want:
                    data = got
                    break
            if data is None:
                cl.metrics.bump("rereplication_failed_blocks")
                continue
            tnode.deliver(cl.block_size, cl._now())
            tnode.volume.write(lba, data)
            copied += 1
        chain[chain.index(dead)] = target
        cl.placement.transfer(dead, target, copied)
        cl.metrics.bump("rereplicated_chunks")
        cl.metrics.bump("rereplicated_blocks", copied)
        return copied

    def repair_divergent(self, sample_every: int = 1) -> int:
        """Partition-heal convergence: rewrite every sampled block whose
        live copy disagrees with the cluster ledger from a verified
        sibling (the cross-node analogue of ``ReplicaResyncer`` repair;
        counted as ``resync_repairs``)."""
        cl = self.cluster
        repaired = 0
        with cl._lock:
            chains = list(cl._chains.items())
        for chunk, chain in chains:
            base = chunk * cl.cfg.chunk_blocks
            top = min(base + cl.cfg.chunk_blocks, cl.n_lbas)
            for lba in range(base, top, sample_every):
                want = cl._crcs.get(lba)
                if want is None:
                    continue
                good, bad = None, []
                for ni in chain:
                    node = cl.nodes[ni]
                    if not node.alive or node.partitioned:
                        continue
                    data = node.volume.read(lba)
                    if cl._crc(data) == want:
                        good = data
                    else:
                        bad.append(ni)
                if good is None or not bad:
                    continue
                for ni in bad:
                    node = cl.nodes[ni]
                    node.deliver(cl.block_size, cl._now())
                    node.volume.write(lba, good)
                    repaired += 1
        if repaired:
            cl.metrics.bump("resync_repairs", repaired)
        return repaired

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
            self._cond.wait_for(lambda: self._inflight == 0, timeout=10.0)
        if self.pool is not None:
            dropped = self.pool.unregister(self)
            if dropped:
                self._complete_eviction(len(dropped))


def make_cluster(policy: str = "caiti", *, n_lbas: int, n_nodes: int = 3,
                 replication_k: int = 2, chunk_blocks: int = 64,
                 racks: int = 2, placement: str = "spread",
                 node_shards: int = 2, stripe_blocks: int = 16,
                 cache_bytes: int = 8 << 20, shared_workers: int = 2,
                 journal_slots: int = 16, journal_span: int = 8,
                 backend: str = "ram", path: str | None = None,
                 block_size: int = 4096,
                 net_latency_us: float = 5.0, net_mb_s: float = 3000.0,
                 heartbeat_timeout: float = 5.0, now_fn=None,
                 max_inflight: int = 16, aio_workers: int = 2,
                 read_tier_bytes: int = 0,
                 hedge_delay_us: float = 0.0,
                 tenants: list[TenantSpec] | None = None,
                 autotune=None) -> ClusterVolume:
    """Build a cluster volume: ``n_nodes`` member ``StripedVolume``s
    (each unreplicated internally — the CLUSTER provides redundancy; its
    crc ledger does the verification) behind simulated links, spread
    over ``racks`` racks round-robin.  ``path`` prefixes file-backed
    members (``{path}.node{i}``).  ``now_fn`` injects the heartbeat
    clock (tests drive a manual one)."""
    cfg = ClusterConfig(n_lbas=n_lbas, replication_k=replication_k,
                        chunk_blocks=chunk_blocks, block_size=block_size,
                        heartbeat_timeout=heartbeat_timeout,
                        max_inflight=max_inflight, aio_workers=aio_workers,
                        hedge_delay_us=hedge_delay_us)
    infos = [NodeInfo(f"node{i}", rack=i % max(1, racks))
             for i in range(n_nodes)]
    place = PlacementPolicy(infos, k=replication_k, policy=placement)
    nodes = []
    for i, info in enumerate(infos):
        vol = make_volume(policy, n_lbas=n_lbas, n_shards=node_shards,
                          stripe_blocks=stripe_blocks, replicas=1,
                          block_size=block_size, cache_bytes=cache_bytes,
                          shared_workers=shared_workers,
                          journal_slots=journal_slots,
                          journal_span=journal_span, backend=backend,
                          path=f"{path}.node{i}" if path else None,
                          read_tier_bytes=read_tier_bytes,
                          aio_workers=0)
        nodes.append(ClusterNode(
            i, info.name, vol, rack=info.rack,
            link=NetLink(latency_us=net_latency_us, mb_s=net_mb_s),
            now_fn=now_fn))
    cl = ClusterVolume(nodes, cfg, placement=place, now_fn=now_fn)
    for t in (tenants or []):
        cl.add_tenant(t.name, weight=t.weight, rate_mbps=t.rate_mbps,
                      burst_bytes=t.burst_bytes)
    # cluster-scope control plane: autotune=True attaches the stock
    # controller; a Controller instance attaches that one
    if autotune:
        cl.attach_autotuner(None if autotune is True else autotune)
    return cl
