"""Per-tenant QoS for the striped volume: rate limits + weighted fairness.

Two cooperating mechanisms, both standard in block-layer QoS stacks
(blk-iocost / dm-qos lineage):

  * :class:`TokenBucket` — hard per-tenant throughput cap.  Tokens are
    bytes, refilled continuously at ``rate_bytes_s`` up to ``burst_bytes``;
    ``acquire`` blocks the submitting thread until the deficit drains.
  * :class:`WFQGate` — start-time fair queuing (SFQ) over a bounded
    in-flight window.  Each admitted request gets a virtual start tag
    ``S = max(V, F_tenant)`` and advances its tenant's finish tag by
    ``priced_bytes / weight``; the gate dispatches the waiter with the
    smallest start tag whenever an in-flight slot frees.  When the volume
    is the bottleneck, tenant *cost* throughput converges to the weight
    ratio.  Pricing is tier-aware (op/tier tags consulting the unified
    :class:`~repro_torch.volume.admission.AdmissionPolicy`): a DRAM-served read
    costs ``tier_hit_cost_frac`` of a PMem one, and batched journal
    writes are charged once per batch (``charge_batch``) instead of once
    per ``log()`` call.

Both are time-driven with ``time.monotonic`` — real-thread QoS for the
threaded volume.  The discrete-event simulator reimplements the same two
disciplines in virtual time (``repro_torch.core.sim.run_volume_sim_workload``)
so the fairness claims are measurable deterministically.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from dataclasses import dataclass


class QoSError(RuntimeError):
    pass


@dataclass(frozen=True)
class TenantSpec:
    """Declarative tenant description for ``make_volume(tenants=[...])``."""

    name: str
    weight: float = 1.0              # WFQ share when the volume saturates
    rate_mbps: float = 0.0           # hard cap; 0 = unlimited
    burst_bytes: int = 4 << 20


class TokenBucket:
    """Continuous-refill token bucket (tokens are bytes)."""

    def __init__(self, rate_bytes_s: float, burst_bytes: int = 4 << 20,
                 clock=time.monotonic) -> None:
        assert rate_bytes_s > 0
        self.rate = float(rate_bytes_s)
        self.burst = float(burst_bytes)
        self._clock = clock
        self._tokens = self.burst
        self._last = clock()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def acquire(self, nbytes: int) -> float:
        """Block until ``nbytes`` tokens are available; returns wait seconds."""
        waited = 0.0
        while True:
            with self._lock:
                now = self._clock()
                self._refill(now)
                if self._tokens >= nbytes:
                    self._tokens -= nbytes
                    return waited
                need = (nbytes - self._tokens) / self.rate
            time.sleep(min(need, 0.05))
            waited += need

    def try_acquire(self, nbytes: int) -> bool:
        with self._lock:
            self._refill(self._clock())
            if self._tokens >= nbytes:
                self._tokens -= nbytes
                return True
            return False

    def charge(self, nbytes: int) -> None:
        """Non-blocking post-service debit: the balance may go negative
        and the debt settles at the next refill, so a cheap DRAM-served
        read is accounted for without ever sleeping on the PMem budget
        (blk-iocost-style debt).  Subsequent ``acquire`` calls wait the
        debt out."""
        with self._lock:
            self._refill(self._clock())
            self._tokens -= nbytes


class WFQGate:
    """Tier-aware start-time fair queuing admission gate.

    ``admit(tenant, nbytes, op=, tier=)`` blocks until the request is
    scheduled and an in-flight slot is free, then returns a ticket;
    ``done(ticket)`` frees the slot.  Weights are set per tenant via
    ``set_tenant``.

    Virtual time is charged by *op cost*, not raw bytes: with a
    ``policy`` (:class:`~repro_torch.volume.admission.AdmissionPolicy`)
    installed, a read tagged ``tier='transit'``/``'tier'`` — a DRAM copy,
    not a PMem round trip — advances its tenant's finish tag by only
    ``tier_hit_cost_frac`` of its size; an untagged read pays the full
    PMem price up front, and a read that served WORSE than its tag
    settles the remainder post-service via :meth:`charge` (the same debt
    model as ``TokenBucket.charge``).  Batched journal writes occupy a
    slot via ``admit(0, op='log')`` (ordering + inflight bounding, one
    clamped vbyte) and are charged their real bytes once per batch
    through :meth:`charge_batch` — one lock acquisition advances every
    constituent tenant's tag by its aggregate priced bytes.

    Zero-byte ops clamp to one byte: an admit that advanced no virtual
    time would hand its tenant an identical start tag for the *next*
    request, letting it leapfrog earlier waiters in the (S, seq) heap.
    """

    def __init__(self, max_inflight: int = 16, policy=None) -> None:
        assert max_inflight >= 1
        self.max_inflight = max_inflight
        self.policy = policy                  # optional AdmissionPolicy
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._weights: dict[str, float] = {}
        self._finish: dict[str, float] = {}   # per-tenant virtual finish tag
        self._vtime = 0.0                     # virtual time = last start tag
        self._inflight = 0
        self._waiting: list[tuple[float, int]] = []   # heap of (S, seq)
        self._seq = itertools.count()
        self.admitted_bytes: dict[str, int] = {}
        self.vtime_charged: dict[str, float] = {}   # priced bytes per tenant
        self.zero_byte_admits = 0
        self.post_charges = 0                 # charge()/charge_batch debits

    def set_tenant(self, name: str, weight: float = 1.0) -> None:
        with self._lock:
            assert weight > 0
            self._weights[name] = float(weight)
            self._finish.setdefault(name, 0.0)
            self.admitted_bytes.setdefault(name, 0)
            self.vtime_charged.setdefault(name, 0.0)

    def _price(self, nbytes: int, op: str, tier: str | None,
               shard=None) -> float:
        """Priced (virtual-time) bytes of one op.  Clamps ``nbytes >= 1``
        — a zero-byte op must still advance the finish tag (heap-order
        regression) — and never prices below one byte.  ``shard=`` tags
        the op's target device so the policy's limping-shard penalty
        multiplier applies (fail-slow steering)."""
        nbytes = max(1, int(nbytes))
        if self.policy is not None:
            return max(1.0, float(self.policy.op_charge(nbytes, op, tier,
                                                        shard=shard)))
        return float(nbytes)

    def _charge_locked(self, tenant: str, cost: float) -> None:
        base = max(self._vtime, self._finish[tenant])
        self._finish[tenant] = base + cost / self._weights[tenant]
        self.vtime_charged[tenant] += cost

    def admit(self, tenant: str, nbytes: int, op: str = "write",
              tier: str | None = None,
              shard=None) -> tuple[float, int]:
        with self._cond:
            if tenant not in self._weights:
                raise QoSError(f"unknown tenant {tenant!r}")
            if nbytes <= 0 and op != "log":
                # op='log' admits are INTENTIONALLY byte-free (the batch
                # charges the real bytes); anything else is the caller
                # bug the clamp exists for
                self.zero_byte_admits += 1
            cost = self._price(nbytes, op, tier, shard=shard)
            s_tag = max(self._vtime, self._finish[tenant])
            self._finish[tenant] = s_tag + cost / self._weights[tenant]
            self.vtime_charged[tenant] += cost
            seq = next(self._seq)
            heapq.heappush(self._waiting, (s_tag, seq))
            while not (self._inflight < self.max_inflight
                       and self._waiting and self._waiting[0][1] == seq):
                self._cond.wait(timeout=0.5)
            heapq.heappop(self._waiting)
            self._inflight += 1
            self._vtime = max(self._vtime, s_tag)
            self.admitted_bytes[tenant] += max(0, nbytes)
            self._cond.notify_all()
            return (s_tag, seq)

    def done(self, ticket) -> None:
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    def charge(self, tenant: str, nbytes: int, op: str = "write",
               tier: str | None = None) -> float:
        """Non-blocking post-service virtual-time debit (the WFQ analogue
        of ``TokenBucket.charge``): advances the tenant's finish tag
        without queueing or occupying a slot — the debt settles as the
        tenant's NEXT admits inherit the later tag.  The volume uses it
        to settle the PMem remainder of a read that was admitted at the
        optimistic DRAM price but missed every DRAM tier.  Returns the
        priced bytes."""
        with self._lock:
            if tenant not in self._weights:
                raise QoSError(f"unknown tenant {tenant!r}")
            cost = self._price(nbytes, op, tier)
            self._charge_locked(tenant, cost)
            self.post_charges += 1
            return cost

    def charge_batch(self, nbytes_by_tenant: dict,
                     op: str = "log") -> dict[str, float]:
        """Charge a batched log flush to its constituent tenants in ONE
        lock acquisition: each tenant's finish tag advances once by its
        aggregate priced bytes for the batch (instead of once per
        ``log()`` call).  Returns the priced bytes per tenant."""
        out: dict[str, float] = {}
        with self._lock:
            for tenant, nbytes in nbytes_by_tenant.items():
                if tenant not in self._weights:
                    raise QoSError(f"unknown tenant {tenant!r}")
                cost = self._price(nbytes, op, None)
                self._charge_locked(tenant, cost)
                out[tenant] = cost
            if nbytes_by_tenant:
                self.post_charges += 1
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "vtime": self._vtime,
                "finish": dict(self._finish),
                "vtime_charged": {t: int(c)
                                  for t, c in self.vtime_charged.items()},
                "admitted_bytes": dict(self.admitted_bytes),
                "zero_byte_admits": self.zero_byte_admits,
                "post_charges": self.post_charges,
            }
