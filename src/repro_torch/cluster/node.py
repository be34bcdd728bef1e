"""Cluster member: one striped volume behind a simulated network link.

A :class:`ClusterNode` wraps a per-node ``StripedVolume`` (the paper's
full stack: transit cache over BTT over PMem, journaled and striped)
behind a :class:`NetLink` that models the wire in **virtual time** —
the same technique as ``core/sim.py``: latency and bandwidth are
accounted, never slept, so the functional layer stays single-core fast
and deterministic while the performance contrasts live in ``SimCluster``.

Failure modes are explicit and separable:

  * ``kill()`` — fail-stop: the node's process is gone.  Every delivery
    raises :class:`NodeDownError`; the data on its volume is considered
    lost to the cluster (re-replication regenerates it onto survivors);
  * ``partition(True)`` — the node is healthy but unreachable:
    deliveries raise :class:`NetworkPartitionError` until the partition
    heals.  A heal brings the old data back, possibly divergent — the
    cluster's crc ledger arbitrates;
  * heartbeats — every successful delivery (and every
    :meth:`HeartbeatMonitor.tick`) stamps ``last_beat``; a node whose
    beat goes stale past the timeout is *suspected dead* regardless of
    why (fail-stop and partition look identical from the outside, the
    classic failure-detector ambiguity), and the ReReplicator treats
    suspicion as death — HDFS semantics.

Clocks are injected (``now_fn``): tests drive a manual clock so the
heartbeat timeout sweep is deterministic; production defaults to
``time.monotonic``.
"""
from __future__ import annotations

import time


class ClusterError(RuntimeError):
    """Base class for cluster-layer delivery failures."""


class NodeDownError(ClusterError):
    """Delivery to a fail-stopped (killed) node."""


class NetworkPartitionError(ClusterError):
    """Delivery to a partitioned (unreachable but alive) node."""


class ClusterUnavailableError(ClusterError):
    """No live replica could serve the request."""


class NetLink:
    """Virtual-time network pipe: ``latency_us`` per message plus
    ``mb_s`` streaming bandwidth (MB/s == bytes/us, so the math is exact
    in virtual time).  Transfers are *accounted*, not slept."""

    __slots__ = ("latency_us", "mb_s", "bytes_moved", "msgs", "vtime_us")

    def __init__(self, latency_us: float = 5.0, mb_s: float = 3000.0) -> None:
        assert mb_s > 0
        self.latency_us = latency_us
        self.mb_s = mb_s
        self.bytes_moved = 0
        self.msgs = 0
        self.vtime_us = 0.0

    def xfer_us(self, nbytes: int) -> float:
        return self.latency_us + nbytes / self.mb_s

    def account(self, nbytes: int) -> float:
        """Record one transfer; returns its virtual duration (us)."""
        dur = self.xfer_us(nbytes)
        self.bytes_moved += nbytes
        self.msgs += 1
        self.vtime_us += dur
        return dur

    def stats(self) -> dict:
        return {"bytes_moved": self.bytes_moved, "msgs": self.msgs,
                "vtime_us": round(self.vtime_us, 3)}


class ClusterNode:
    """One datanode: volume + link + liveness state."""

    def __init__(self, idx: int, name: str, volume, *, rack: int = 0,
                 link: NetLink | None = None, now_fn=None) -> None:
        self.idx = idx
        self.name = name
        self.volume = volume
        self.rack = rack
        self.link = link or NetLink()
        self._now = now_fn or time.monotonic
        self.alive = True
        self.partitioned = False
        self.last_beat = self._now()

    # ------------------------------------------------------------- liveness
    def beat(self, now: float | None = None) -> None:
        self.last_beat = self._now() if now is None else now

    def kill(self) -> None:
        self.alive = False

    def partition(self, flag: bool = True) -> None:
        self.partitioned = flag

    # ------------------------------------------------------------- delivery
    def deliver(self, nbytes: int, now: float | None = None) -> float:
        """One message of ``nbytes`` arrives over the link.  Raises when
        the node cannot receive it; otherwise accounts the transfer,
        refreshes the heartbeat and returns the virtual duration."""
        if not self.alive:
            raise NodeDownError(f"node {self.name} is down")
        if self.partitioned:
            raise NetworkPartitionError(f"node {self.name} is partitioned")
        dur = self.link.account(nbytes)
        self.beat(now)
        return dur

    def close(self) -> None:
        # a killed node's volume still owns threads (eviction pool, aio
        # workers) in this process — release them quietly; its media is
        # already considered lost to the cluster
        try:
            self.volume.close()
        except Exception:
            if self.alive:
                raise

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        st = "up" if self.alive else "DOWN"
        if self.partitioned:
            st += "/partitioned"
        return f"ClusterNode({self.name}, rack={self.rack}, {st})"


class HeartbeatMonitor:
    """Suspicion by staleness: a node whose last beat is older than
    ``timeout`` is suspected dead.  The monitor never reads ``alive``
    directly — detection goes through the beat channel only, so a
    partition and a crash are (correctly) indistinguishable to it."""

    def __init__(self, nodes: list[ClusterNode], *, timeout: float = 5.0,
                 now_fn=None) -> None:
        self.nodes = nodes
        self.timeout = timeout
        self._now = now_fn or time.monotonic

    def tick(self, now: float | None = None) -> None:
        """One heartbeat exchange: every reachable node beats.  Dead and
        partitioned nodes cannot answer, so their stamps go stale."""
        now = self._now() if now is None else now
        for n in self.nodes:
            if n.alive and not n.partitioned:
                n.beat(now)

    def check(self, now: float | None = None) -> list[int]:
        """Indices of suspected-dead nodes (stale beats)."""
        now = self._now() if now is None else now
        return [n.idx for n in self.nodes
                if now - n.last_beat > self.timeout]
