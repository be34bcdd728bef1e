"""Asynchronous submission/completion I/O frontend for the striped volume.

Every entry point the stack had so far — ``CaitiCache.write``,
``StripedVolume.write_multi`` / ``fsync`` / ``read`` — is a *blocking*
call: the submitting thread rides the whole stack down to the media and
back, so callers serialize exactly the PMem stalls the paper's transit
cache exists to hide.  :class:`AsyncIOEngine` is the io_uring-style
front end that decouples submission from completion:

  * **per-tenant submission queues** — ``submit(op, ...)`` appends a
    :class:`Ticket` to the caller's tenant SQ and returns immediately;
    dispatch merges the SQs in global submission order (per-tenant FIFO,
    oldest seq first), so one tenant's burst cannot reorder another's
    ops;
  * **shared completion ring** — finished tickets land on one CQ;
    ``poll()`` drains it (oldest first), ``wait(ticket)`` blocks for one
    ticket.  ``Ticket.result()`` returns the op's value or re-raises its
    error;
  * **backpressure at submit time** — each tenant has a bounded
    in-flight window (``max_inflight_per_tenant``, the submit-side
    analogue of ``WFQGate``'s dispatch window).  A submit that would
    exceed the bound FAILS ITS TICKET with :class:`SubmitError` instead
    of blocking the caller or deadlocking the ring; deeper WFQ pricing
    still happens on the execution path (ops run through the volume's
    normal ``tenant=`` admission: token bucket + tier-aware SFQ tags);
  * **async fsync barriers** — an ``op='fsync'`` ticket dispatches only
    once every earlier-submitted ticket has completed (io_uring's
    IO_DRAIN), then rides the volume's existing
    :class:`~repro_torch.volume.journal.GroupCommitter`: concurrent async
    fsyncs from several engine workers elect ONE leader for the batch.
    Chained ``write_multi`` tickets likewise coalesce behind the
    :class:`~repro_torch.volume.journal.LogBatcher` leader when workers
    overlap;
  * **eviction-drain completion callbacks** — an ``op='flush'`` ticket
    (the WBQ-drain barrier) does not park a worker in
    ``CaitiCache.flush``: it registers a one-shot drain waiter on every
    shard cache (``CaitiCache.add_drain_waiter``) and completes from the
    eviction pool's completion path when the last in-flight writeback
    lands;
  * **per-ticket failures** — an injected device error (or a journal
    ring overflow, a cancelled ticket, a submit after close) surfaces on
    THAT ticket's ``error``, never as a stack-wide exception tearing
    down the ring.  Only :class:`~repro_torch.core.SimulatedCrash` is fatal:
    it models power loss, so the engine marks itself dead, fails every
    queued ticket, and (in deterministic mode) re-raises so crash
    harnesses observe the loss exactly like the synchronous sweeps do;
  * **registered buffer pools** (io_uring ``register_buffers``) — a
    :class:`BufferRegistry` of pre-pinned arrays.  A write whose payload
    is a :class:`RegisteredBuf` is PINNED, not snapshotted: the engine
    holds the caller's array until the op completes and releases it back
    to the pool from the completion (or cancel — see below) path.  An
    UNREGISTERED mutable payload (ndarray / bytearray / memoryview) gets
    a defensive staging copy at submit — the caller may reuse it
    immediately, which is exactly the copy tax registration removes
    (``bytes`` payloads are immutable and ride for free either way).  A
    caller that re-``acquire()``\\ s from an exhausted pool steals the
    oldest still-QUEUED pinned buffer: the engine snapshots it at THAT
    moment (copy-on-evict — the only copy left, and only when the
    caller reuses a slot before durability).  Reads accept ``out=`` and
    land directly in the caller's (registered) array — the completion
    hands back the caller's own buffer, no post-poll copy;
  * **linked SQEs** (io_uring ``IO_LINK``) — ``submit(...,
    link_to=parent)`` makes a ticket chain: the dependent dispatches
    only after its parent completes OK, IN-ENGINE, so write→fsync,
    write→read-back-verify and restore read→scatter sequences need one
    ``wait`` on the chain tail instead of one poll round trip per hop.
    A failed (or cancelled) link fails every transitive dependent with
    :class:`LinkCancelledError` ("ECANCELED") on the completion ring —
    dependents are cancelled, never silently dropped, and unrelated
    tickets are untouched (per-ticket isolation).  Cancelling a
    mid-chain ticket likewise cancels its dependents AND releases every
    registered buffer the chain had pinned back to the pool.

Two execution modes share all of the above:

  * ``n_workers >= 1`` (default): background worker threads drain the
    SQs — real overlap for the threaded volume;
  * ``n_workers == 0`` (**deterministic mode**, used by the
    crash/fault-injection harness in ``tests/aio_harness.py``): nothing
    runs until ``poll()`` / ``wait()`` executes queued ops inline, one
    at a time, in submission order — every interleaving of
    submit/poll/crash is replayable from a seed.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from repro_torch.core.pmem import SimulatedCrash

# ticket states
QUEUED, RUNNING, DONE = range(3)

_BARRIER_OPS = ("fsync", "flush")
_OPS = ("write", "write_multi", "read", "fsync", "flush")
_PENDING = object()          # sentinel: op completes via callback later


class TicketError(RuntimeError):
    """Base class for engine-side (not device-side) ticket failures."""


class SubmitError(TicketError):
    """The submit itself was refused (closed engine / unknown op)."""


class BackpressureError(SubmitError):
    """The submit was refused because the tenant is at its in-flight
    bound — the retryable refusal: settle a completion and resubmit."""


class CancelledError(TicketError):
    """The ticket was cancelled before dispatch."""


class LinkCancelledError(CancelledError):
    """ECANCELED: an earlier ticket in this SQE chain failed (or was
    cancelled), so this dependent never dispatched.  The chain's root
    cause rides on the PARENT ticket's ``error``."""


class RegisteredBuf:
    """One buffer of a :class:`BufferRegistry` pool.  ``data`` is the
    caller-visible uint8 array; fill it and pass the handle as a write's
    ``data=`` (or a read's ``out=``) to pin it instead of copying."""

    __slots__ = ("idx", "data", "_registry")

    def __init__(self, idx: int, data, registry) -> None:
        self.idx = idx
        self.data = data
        self._registry = registry

    @property
    def nbytes(self) -> int:
        return self.data.nbytes

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"RegisteredBuf({self.idx}, {self.data.nbytes}B)"


class BufferRegistry:
    """Registered buffer pool (io_uring ``register_buffers``): a fixed
    set of pre-allocated arrays the engine pins instead of copying.

    Lifecycle: ``acquire()`` hands out a free buffer; submitting it pins
    it to that ticket; the ticket's completion (success, failure, cancel
    — including an ECANCELED chain cascade) releases it back to the
    free list.  ``acquire()`` on an exhausted pool performs
    **copy-on-evict**: the oldest pinned buffer whose ticket is still
    QUEUED is snapshotted into the ticket (the payload stays correct)
    and the slot is reused — the only remaining copy, paid only when
    the caller reuses a slot before durability.  If nothing is
    stealable (every pinned ticket already dispatched), a transient
    unpooled buffer is handed out instead of blocking the caller."""

    def __init__(self, engine: "AsyncIOEngine", n_buffers: int,
                 buf_bytes: int) -> None:
        assert n_buffers >= 1 and buf_bytes >= 1
        self._engine = engine
        self.buf_bytes = buf_bytes
        self._bufs = [RegisteredBuf(i, np.zeros(buf_bytes, np.uint8), self)
                      for i in range(n_buffers)]
        self._free = list(range(n_buffers - 1, -1, -1))
        self._pins: dict[int, Ticket] = {}      # buf idx -> pinning ticket
        self.copy_on_evict = 0
        self.overflow_allocs = 0

    def __len__(self) -> int:
        return len(self._bufs)

    def free_count(self) -> int:
        with self._engine._cond:
            return len(self._free)

    def acquire(self) -> RegisteredBuf:
        eng = self._engine
        with eng._cond:
            if self._free:
                return self._bufs[self._free.pop()]
            # copy-on-evict: steal the oldest pinned buffer whose ticket
            # has not dispatched yet (its payload snapshots into the
            # ticket, so the in-flight write stays correct)
            for idx in sorted(self._pins,
                              key=lambda i: self._pins[i].seq):
                if self._steal_locked(idx):
                    return self._bufs[idx]
            self.overflow_allocs += 1
            return RegisteredBuf(-1, np.zeros(self.buf_bytes, np.uint8),
                                 self)

    def release(self, buf: RegisteredBuf) -> None:
        """Return an acquired-but-never-submitted buffer to the pool."""
        with self._engine._cond:
            if buf.idx >= 0 and buf.idx not in self._pins \
                    and buf.idx not in self._free:
                self._free.append(buf.idx)

    # engine-internal (all called under the engine lock) ------------------
    def _steal_locked(self, idx: int) -> bool:
        t = self._pins[idx]
        if t.state != QUEUED:
            return False                   # already on its way to media
        buf = self._bufs[idx]
        if t.out is buf:
            return False                   # a read landing target cannot
        data, blocks = t.value \
            if isinstance(t.value, tuple) else (None, None)
        snap = bytes(memoryview(buf.data))
        if data is buf:
            t.value = (snap, blocks)
        elif isinstance(blocks, (list, tuple)) and \
                any(b is buf for b in blocks):
            t.value = (data, [snap if b is buf else b for b in blocks])
        else:                              # pragma: no cover - defensive
            return False
        t._bufs.remove(buf)
        del self._pins[idx]
        self.copy_on_evict += 1
        eng = self._engine
        eng.staging_copies += 1
        eng.staging_copy_bytes += len(snap)
        eng._bump("staging_copies")
        eng._bump("staging_copy_bytes", len(snap))
        return True

    def _pin_locked(self, buf: RegisteredBuf, t: "Ticket") -> None:
        if buf.idx >= 0:
            self._pins[buf.idx] = t
        t._bufs.append(buf)

    def _release_ticket_locked(self, t: "Ticket") -> None:
        for buf in t._bufs:
            if buf.idx >= 0 and self._pins.get(buf.idx) is t:
                del self._pins[buf.idx]
                self._free.append(buf.idx)
        t._bufs = []

    def stats(self) -> dict:
        with self._engine._cond:
            return {
                "n_buffers": len(self._bufs),
                "buf_bytes": self.buf_bytes,
                "free": len(self._free),
                "pinned": len(self._pins),
                "copy_on_evict": self.copy_on_evict,
                "overflow_allocs": self.overflow_allocs,
            }


class Ticket:
    """One asynchronous I/O: handle returned by ``submit``, delivered on
    the completion ring.  ``value`` holds a read's data; ``error`` holds
    the per-ticket failure (device error, journal overflow, cancel,
    refused submit)."""

    __slots__ = ("tid", "seq", "op", "lba", "tenant", "state", "value",
                 "error", "link_to", "link_depth", "out", "replica",
                 "_bufs", "_discard", "_engine")

    def __init__(self, tid: int, seq: int, op: str, lba: int,
                 tenant, engine) -> None:
        self.tid = tid
        self.seq = seq
        self.op = op
        self.lba = lba
        self.tenant = tenant
        self.state = QUEUED
        self.value = None
        self.error: BaseException | None = None
        self.link_to: "Ticket | None" = None   # SQE chain parent
        self.link_depth = 0                    # hops from the chain head
        self.out = None                        # read landing buffer
        self.replica = 0                       # hedge: which copy to read
        self._bufs: list = []                  # pinned registered buffers
        self._discard = False                  # cancelled while RUNNING
        self._engine = engine

    @property
    def done(self) -> bool:
        return self.state == DONE

    @property
    def ok(self) -> bool:
        return self.state == DONE and self.error is None

    def result(self, timeout: float | None = None):
        """Block until complete; return the op's value or re-raise the
        ticket's error."""
        self._engine.wait(self, timeout=timeout)
        if self.error is not None:
            raise self.error
        return self.value

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        st = ("queued", "running", "done")[self.state]
        return (f"Ticket({self.tid}, {self.op}@{self.lba}, "
                f"tenant={self.tenant}, {st}"
                f"{', err=' + repr(self.error) if self.error else ''})")


class AsyncIOEngine:
    """io_uring-style submit/poll front end over a :class:`StripedVolume`
    (anything speaking write/write_multi/read/fsync/flush works).

    ``n_workers`` — background dispatch threads (0 = deterministic
    inline mode: ops execute during ``poll``/``wait``).
    ``max_inflight_per_tenant`` — submit-side backpressure window; a
    tenant over its bound gets a failed ticket, never a blocked submit.
    """

    def __init__(self, volume, *, n_workers: int = 2,
                 max_inflight_per_tenant: int = 32) -> None:
        assert n_workers >= 0 and max_inflight_per_tenant >= 1
        self.vol = volume
        self.max_inflight_per_tenant = max_inflight_per_tenant
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._sqs: dict[object, deque[Ticket]] = {}   # tenant -> SQ
        self._cq: deque[Ticket] = deque()             # shared completion ring
        self._open: dict[int, Ticket] = {}            # seq -> live ticket
        self._inflight: dict[object, int] = {}        # per-tenant live count
        self._deps: dict[int, list[Ticket]] = {}      # parent seq -> linked
        self._tids = itertools.count(1)
        self._seqs = itertools.count(1)
        self._closed = False
        self._dead: BaseException | None = None
        self.registry: BufferRegistry | None = None
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.cancelled = 0
        # zero-copy data plane accounting
        self.copies_avoided = 0       # pinned writes + out= read landings
        self.bytes_pinned = 0         # cumulative payload bytes pinned
        self.staging_copies = 0       # defensive snapshots (+ steals)
        self.staging_copy_bytes = 0
        self.links_submitted = 0      # tickets carrying link_to
        self.link_cancelled = 0       # dependents failed with ECANCELED
        self.link_depth_max = 0       # deepest chain seen
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"aio-{i}")
            for i in range(n_workers)
        ]
        for w in self._workers:
            w.start()

    @property
    def inline(self) -> bool:
        return not self._workers

    # ------------------------------------------------------- registered bufs
    def register_buffers(self, n_buffers: int,
                         buf_bytes: int) -> BufferRegistry:
        """Create (once) the engine's registered buffer pool.  Payloads
        submitted as :class:`RegisteredBuf` handles are pinned, not
        copied; reads with a registered ``out=`` land in place."""
        with self._cond:
            if self.registry is None:
                self.registry = BufferRegistry(self, n_buffers, buf_bytes)
            else:
                assert len(self.registry) == n_buffers \
                    and self.registry.buf_bytes == buf_bytes, \
                    "buffer pool already registered with a different shape"
            return self.registry

    # ------------------------------------------------------------ submission
    def submit(self, op: str, lba: int = 0, data=None, blocks=None,
               tenant=None, block: bool = False, link_to: Ticket | None = None,
               out=None, replica: int = 0) -> Ticket:
        """Queue one op; returns its ticket immediately.  NEVER raises
        for per-op conditions: a refused submit (closed engine, tenant
        over its in-flight bound, unknown op) comes back as an
        already-failed ticket in the caller's hand — with no completion
        event, like io_uring's -EAGAIN.

        ``block=True`` turns the in-flight bound from a refusal into
        BLOCKING backpressure: the submit waits for the tenant's window
        (executing queued ops itself in deterministic mode) instead of
        failing the ticket — what batch producers (blockstore puts, the
        request log) want.  Other refusals still fail the ticket.

        ``link_to=parent`` chains this ticket behind ``parent``
        (IO_LINK): it dispatches only after the parent completes OK and
        fails with :class:`LinkCancelledError` if the parent fails.
        ``out=`` (reads) lands the data directly in the caller's array /
        :class:`RegisteredBuf` — the completion value IS that buffer.
        ``replica=`` (reads) routes the op to that copy of the block —
        the hedge path reads the replica while the primary is in
        flight."""
        while True:
            t = self._submit_once(op, lba, data, blocks, tenant,
                                  count_refusal=not block,
                                  link_to=link_to, out=out, replica=replica)
            if not (block and t.state == DONE
                    and isinstance(t.error, BackpressureError)):
                return t
            if self.inline:
                if self._run_inline(1) == 0:
                    time.sleep(0.001)    # head blocked on a drain
            else:                        # callback: let the pool run
                with self._cond:
                    if self._inflight.get(tenant, 0) \
                            >= self.max_inflight_per_tenant:
                        self._cond.wait(timeout=0.05)

    def try_submit(self, op: str, lba: int = 0, data=None, blocks=None,
                   tenant=None, link_to: Ticket | None = None,
                   out=None, replica: int = 0) -> Ticket | None:
        """Non-blocking window probe: returns None — without counting a
        failure — when the tenant is at its in-flight bound, the ticket
        otherwise.  Flow-control probes (the blockstore's restore pump)
        must not pollute the per-ticket failure stats."""
        t = self._submit_once(op, lba, data, blocks, tenant,
                              count_refusal=False, link_to=link_to, out=out,
                              replica=replica)
        if t.state == DONE and isinstance(t.error, BackpressureError):
            return None
        return t

    def _bump(self, event: str, n: int = 1) -> None:
        """Mirror a zero-copy counter onto the volume's Metrics (leaf
        lock — safe under the engine lock) so ``Metrics.zerocopy_path()``
        and ``scrub`` see the same numbers as ``stats()``."""
        m = getattr(self.vol, "metrics", None)
        if m is not None:
            m.bump(event, n)

    def _snapshot_locked(self, payload):
        """Defensive staging copy of an UNREGISTERED mutable payload:
        the caller may reuse its buffer the moment submit returns, so a
        mutable array must not ride the ticket by reference.  This is
        the per-op copy tax that :class:`BufferRegistry` pinning
        removes.  ``bytes`` (immutable) payloads pass through."""
        if isinstance(payload, (bytearray, memoryview, np.ndarray)):
            snap = bytes(memoryview(np.ascontiguousarray(payload)
                                    if isinstance(payload, np.ndarray)
                                    else payload))
            self.staging_copies += 1
            self.staging_copy_bytes += len(snap)
            self._bump("staging_copies")
            self._bump("staging_copy_bytes", len(snap))
            return snap
        return payload

    def _pin_or_snapshot_locked(self, payload, t: Ticket):
        if isinstance(payload, RegisteredBuf):
            assert payload._registry is self.registry, \
                "buffer registered with a different engine"
            self.registry._pin_locked(payload, t)
            self.copies_avoided += 1
            self.bytes_pinned += payload.nbytes
            self._bump("copies_avoided")
            self._bump("bytes_pinned", payload.nbytes)
            return payload
        return self._snapshot_locked(payload)

    def _submit_once(self, op, lba, data, blocks, tenant,
                     count_refusal: bool = True, link_to=None,
                     out=None, replica: int = 0) -> Ticket:
        with self._cond:
            t = Ticket(next(self._tids), next(self._seqs), op, lba,
                       tenant, self)
            t.replica = replica
            err = None
            if op not in _OPS:
                err = SubmitError(f"unknown op {op!r}")
            elif self._closed:
                err = SubmitError("submit after close")
            elif self._dead is not None:
                err = SubmitError(f"engine dead: {self._dead!r}")
            elif self._inflight.get(tenant, 0) \
                    >= self.max_inflight_per_tenant:
                err = BackpressureError(
                    f"tenant {tenant!r} over its in-flight bound "
                    f"({self.max_inflight_per_tenant})")
            if err is not None:
                # refused submissions complete in the caller's hand and
                # generate NO completion event (io_uring's -EAGAIN): a
                # retry loop must not litter the ring, and a blocking
                # submit's wait attempts stay counter-invisible
                t.state = DONE
                t.error = err
                if count_refusal or not isinstance(err, BackpressureError):
                    self.submitted += 1
                    self.failed += 1
                return t
            if link_to is not None:
                assert link_to._engine is self, \
                    "link parent belongs to a different engine"
                self.links_submitted += 1
                self._bump("links_submitted")
                t.link_depth = link_to.link_depth + 1
                if t.link_depth > self.link_depth_max:
                    # Metrics only counts up: keep its link_depth_max
                    # equal to the high-water mark by bumping the delta
                    self._bump("link_depth_max",
                               t.link_depth - self.link_depth_max)
                    self.link_depth_max = t.link_depth
                if link_to.state == DONE and link_to.error is not None:
                    # chained behind an already-failed parent: the
                    # dependent lands on the RING as ECANCELED (a real
                    # CQE, unlike a refused submit — the chain is
                    # cancelled, never silently dropped)
                    t.link_to = link_to     # root cause stays reachable
                    t.state = DONE
                    t.error = LinkCancelledError(
                        f"ECANCELED: link parent ticket {link_to.tid} "
                        f"failed: {link_to.error!r}")
                    self.submitted += 1
                    self.cancelled += 1
                    self.link_cancelled += 1
                    self._bump("link_cancelled")
                    self._cq.append(t)
                    self._cond.notify_all()
                    return t
                if link_to.state != DONE:   # parent done-OK needs no gate
                    t.link_to = link_to
                    self._deps.setdefault(link_to.seq, []).append(t)
            self.submitted += 1
            if data is not None:
                data = self._pin_or_snapshot_locked(data, t)
            if blocks is not None:
                blocks = [self._pin_or_snapshot_locked(b, t)
                          for b in blocks]
            if out is not None:
                assert op == "read", "out= is only meaningful for reads"
                t.out = out
                if isinstance(out, RegisteredBuf):
                    self.registry._pin_locked(out, t)
                    self.bytes_pinned += out.nbytes
                    self._bump("bytes_pinned", out.nbytes)
                self.copies_avoided += 1    # no post-poll landing copy
                self._bump("copies_avoided")
            t.value = (data, blocks)          # op args ride the ticket
            self._sqs.setdefault(tenant, deque()).append(t)
            self._open[t.seq] = t
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self._cond.notify_all()
            return t

    def cancel(self, ticket: Ticket) -> bool:
        """Cancel a still-queued ticket: it completes on the ring with
        :class:`CancelledError`.  Returns False once dispatched (an op
        already on its way to the media cannot be recalled) — EXCEPT a
        dispatched READ, which is side-effect-free: cancelling a RUNNING
        read marks it discarded, its result is dropped (an ``out=``
        landing target is never written — the landing copy happens under
        the engine lock at completion and checks the discard flag, so a
        cancelled read can never leave partial data in the caller's
        array), and it still completes on the ring exactly once, with
        :class:`CancelledError`.  This is the hedge-loser path: the
        slow replica's read is recalled whether or not it has already
        reached the media.

        A cancelled mid-chain ticket cascades: every linked dependent
        completes with :class:`LinkCancelledError`, and ALL registered
        buffers the ticket (and its dependents) had pinned go back to
        the pool from the same completion path — a cancel landing
        between submit and poll can never leak a pinned buffer."""
        with self._cond:
            if ticket.state == RUNNING and ticket.op == "read" \
                    and ticket.seq in self._open:
                ticket._discard = True      # _finish_locked converts the
                return True                 # completion to CancelledError
            if ticket.state != QUEUED or ticket.seq not in self._open:
                return False
            sq = self._sqs.get(ticket.tenant)
            try:
                sq.remove(ticket)
            except (ValueError, AttributeError):
                return False
            self._finish_locked(ticket, error=CancelledError("cancelled"))
            return True

    # ------------------------------------------------------------ completion
    def poll(self, max_ops: int | None = None) -> list[Ticket]:
        """Drain the completion ring (oldest first).  In deterministic
        mode this FIRST executes up to ``max_ops`` queued ops inline in
        submission order (all eligible ops when ``None``), so
        ``submit(); poll()`` is a replayable schedule."""
        if self.inline:
            self._run_inline(max_ops)
        with self._cond:
            out = list(self._cq)
            self._cq.clear()
            return out

    def wait(self, ticket: Ticket, timeout: float | None = None) -> Ticket:
        """Block until ``ticket`` completes.  Waiting CONSUMES the
        completion — the ticket will not show up on a later ``poll`` —
        so wait()-only consumers (blockstore, request log) never grow
        the ring.  In deterministic mode this executes queued ops ONE at
        a time, stopping the moment the ticket completes: ops submitted
        after it stay queued (the replayable schedule does not advance
        past the caller's intent)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._cond:
                if ticket.state == DONE:
                    try:
                        self._cq.remove(ticket)
                    except ValueError:
                        pass             # already polled
                    return ticket
            # never oversleep the caller's deadline: a hedge delay is
            # routinely far below the 50 ms poll granularity
            step = 0.05 if deadline is None \
                else max(1e-4, min(0.05, deadline - time.monotonic()))
            if self.inline:
                if self._run_inline(1) == 0:
                    with self._cond:     # head blocked on a drain
                        if ticket.state != DONE:    # callback: let the
                            self._cond.wait(timeout=step)   # pool run
            else:
                with self._cond:
                    if ticket.state != DONE:
                        self._cond.wait(timeout=step)
            if deadline is not None and time.monotonic() >= deadline:
                with self._cond:
                    if ticket.state == DONE:     # completed AT the
                        try:                     # deadline: not a timeout
                            self._cq.remove(ticket)
                        except ValueError:
                            pass
                        return ticket
                    raise TimeoutError(
                        f"ticket {ticket.tid} still "
                        f"{('queued', 'running', 'done')[ticket.state]}")

    def wait_any(self, tickets, timeout: float | None = None) -> Ticket:
        """Block until ANY of ``tickets`` completes; returns the first
        one found DONE (consuming its CQE, like ``wait``).  This is the
        hedged-read race: wait on {primary, hedge}, take the winner,
        cancel the loser.  In deterministic mode queued ops execute one
        at a time in submission order, so the primary (older seq) always
        races first — replayable like every other inline schedule."""
        tickets = list(tickets)
        assert tickets, "wait_any needs at least one ticket"
        deadline = None if timeout is None else time.monotonic() + timeout

        def first_done_locked():
            for t in tickets:
                if t.state == DONE:
                    try:
                        self._cq.remove(t)
                    except ValueError:
                        pass         # already polled
                    return t
            return None

        while True:
            with self._cond:
                t = first_done_locked()
                if t is not None:
                    return t
            step = 0.05 if deadline is None \
                else max(1e-4, min(0.05, deadline - time.monotonic()))
            if self.inline:
                if self._run_inline(1) == 0:
                    with self._cond:
                        t = first_done_locked()
                        if t is not None:
                            return t
                        self._cond.wait(timeout=step)
            else:
                with self._cond:
                    if all(t.state != DONE for t in tickets):
                        self._cond.wait(timeout=step)
            if deadline is not None and time.monotonic() >= deadline:
                with self._cond:
                    t = first_done_locked()
                    if t is not None:
                        return t
                    raise TimeoutError(
                        f"none of {len(tickets)} tickets completed")

    def drain(self, timeout: float | None = None) -> None:
        """Wait for every submitted ticket to complete."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if self.inline:
                self._run_inline(None)
            with self._cond:
                if not self._open:
                    return
                if self._dead is not None:
                    raise self._dead
                self._cond.wait(timeout=0.05)
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"{len(self._open)} tickets open")

    # -------------------------------------------------------------- dispatch
    def _pick_locked(self):
        """(ticket, blocked): the eligible queued ticket with the oldest
        seq across every SQ.  Barriers are not ready while any earlier
        ticket is still open (IO_DRAIN: nothing later than a pending
        barrier dispatches either).  A link-gated head (parent still in
        flight) blocks only ITS chain: younger heads of other SQs run —
        per-tenant FIFO holds, cross-tenant overlap survives."""
        heads = sorted((sq[0] for sq in self._sqs.values() if sq),
                       key=lambda t: t.seq)
        if not heads:
            return None, False
        for t in heads:
            if t.op in _BARRIER_OPS and min(self._open) < t.seq:
                return t, True
            p = t.link_to
            if p is not None and p.state != DONE:
                continue             # parent in flight: try another SQ
            return t, False
        return heads[0], True        # every head link-gated: wait

    def _pop_locked(self, ticket: Ticket) -> None:
        self._sqs[ticket.tenant].popleft()
        ticket.state = RUNNING

    def _run_inline(self, max_ops: int | None) -> int:
        n = 0
        while max_ops is None or n < max_ops:
            with self._cond:
                t, blocked = self._pick_locked()
                if t is None or blocked:
                    # a blocked barrier waits on callback-completed
                    # tickets (eviction drains) — the pool threads will
                    # finish them; the caller polls again
                    return n
                self._pop_locked(t)
            self._execute(t)
            n += 1
        return n

    def _worker(self) -> None:
        while True:
            with self._cond:
                while True:
                    if self._dead is not None:
                        self._fail_queued_locked()
                    t, blocked = self._pick_locked()
                    if t is not None and not blocked:
                        self._pop_locked(t)
                        break
                    if self._closed and t is None:
                        return
                    self._cond.wait(timeout=0.2)
            self._execute(t)

    def _execute(self, t: Ticket) -> None:
        data, blocks = t.value if isinstance(t.value, tuple) else (None, None)
        t.value = None
        t0 = time.perf_counter_ns()
        try:
            val = self._run_op(t, data, blocks)
        except SimulatedCrash as e:
            # power loss: the whole ring dies with the machine
            self._fatal(e, t)
            if self.inline:
                raise
            return
        except Exception as e:       # injected device error, journal
            self._observe_svc(t, t0)            # overflow, ... — per-ticket
            self._complete(t, error=e)
            return
        self._observe_svc(t, t0)
        if val is _PENDING:
            return                   # completes via drain callback
        self._complete(t, value=val)

    def _observe_svc(self, t: Ticket, t0: int) -> None:
        """Per-op service-time EWMA on the volume's metrics (fail-slow
        groundwork: ``Metrics.per_node()`` keys ``aio::<op>``)."""
        m = getattr(self.vol, "metrics", None)
        if m is not None:
            m.observe(f"svc::aio::{t.op}", time.perf_counter_ns() - t0)

    @staticmethod
    def _payload(data):
        """A pinned RegisteredBuf rides the ticket as the handle; the
        device stack consumes the underlying array via the buffer
        protocol (``np.frombuffer`` — no intermediate copy)."""
        return data.data if isinstance(data, RegisteredBuf) else data

    def _run_op(self, t: Ticket, data, blocks):
        vol = self.vol
        if t.op == "write":
            return vol.write(t.lba, self._payload(data), tenant=t.tenant)
        if t.op == "write_multi":
            return vol.write_multi(t.lba, [self._payload(b) for b in blocks],
                                   tenant=t.tenant)
        if t.op == "read":
            # hedge routing: replica=N reads the Nth copy (striped
            # volume) / starts the chain walk at position N (cluster)
            kw = {"tenant": t.tenant}
            if t.replica:
                kw["replica"] = t.replica
            if t.out is None:
                return vol.read(t.lba, **kw)
            # zero-copy landing: the device stack fills an engine-held
            # scratch in place, then ONE landing memcpy into the
            # CALLER's array happens under the engine lock at the end of
            # the op and checks the discard flag first — a read
            # cancelled in flight (a hedge loser) can never leave
            # partial data in the caller's buffer, and the completion
            # value is still the caller's own buffer (no post-poll copy)
            arr = self._payload(t.out)
            bs = getattr(vol, "block_size", None)
            if isinstance(arr, np.ndarray) and arr.size == bs:
                scratch = np.empty_like(arr)
                try:
                    vol.read(t.lba, out=scratch, **kw)
                    return self._land_out_locked_copy(t, arr, scratch)
                except TypeError:    # volume without out= plumbing
                    pass
            val = vol.read(t.lba, **kw)
            src = val.view(np.uint8).reshape(-1) \
                if isinstance(val, np.ndarray) \
                else np.frombuffer(memoryview(val), dtype=np.uint8)
            return self._land_out_locked_copy(t, arr, src)
        if t.op == "fsync":
            return vol.fsync()       # rides the GroupCommitter leader
        assert t.op == "flush"
        return self._flush_async(t)

    def _land_out_locked_copy(self, t: Ticket, arr, src):
        """Atomic ``out=`` landing: the caller's array is written in one
        memcpy under the engine lock, and ONLY if the ticket has not
        been discarded — cancel() takes the same lock, so the caller
        observes either the full block or an untouched buffer, never a
        torn landing."""
        with self._cond:
            if not t._discard:
                n = min(arr.size, src.size)
                arr[:n] = src[:n]
        return t.out

    def _flush_async(self, t: Ticket):
        """WBQ-drain barrier without parking a worker: register one-shot
        drain waiters on every shard cache; the ticket completes from
        the eviction pool's completion path."""
        caches = [c for c in getattr(self.vol, "_caches", [])
                  if hasattr(c, "add_drain_waiter")]
        if not caches:
            self.vol.flush()
            return None
        for c in caches:
            if hasattr(c, "kick_drain"):
                c.kick_drain()       # staging configs enqueue their WBQs
        state = {"left": 1}          # sentinel guards registration phase
        slock = threading.Lock()

        def child_done() -> None:
            with slock:
                state["left"] -= 1
                fire = state["left"] == 0
            if fire:
                self._complete(t, value=None)

        for c in caches:
            with slock:
                state["left"] += 1
            if not c.add_drain_waiter(child_done):
                child_done()         # already drained
        child_done()                 # drop the sentinel
        return _PENDING

    # ------------------------------------------------------------ accounting
    def _finish_locked(self, t: Ticket, value=None, error=None) -> None:
        if t._discard and not isinstance(error, CancelledError):
            # cancelled while RUNNING (hedge loser): the result — value
            # OR device error — is dropped and the one CQE says cancelled
            value, error = None, CancelledError(
                "cancelled in flight (discarded result)")
        t.value = value
        t.error = error
        t.state = DONE
        self._open.pop(t.seq, None)
        n = self._inflight.get(t.tenant, 0)
        if n:
            self._inflight[t.tenant] = n - 1
        if error is None:
            self.completed += 1
        elif isinstance(error, CancelledError):
            self.cancelled += 1          # cancels are not failures
        else:
            self.failed += 1
        # EVERY completion path — success, device error, cancel, chain
        # cascade, engine death — releases the ticket's pinned buffers;
        # this is the one place, so no path can leak a registered buffer
        if t._bufs and self.registry is not None:
            self.registry._release_ticket_locked(t)
        self._cq.append(t)
        self._cond.notify_all()
        # linked-SQE cascade: a failed/cancelled parent fails every
        # still-queued transitive dependent with ECANCELED ON THE RING
        # (cancelled, never silently dropped); a successful parent just
        # ungates them (``_pick_locked`` reads parent.state)
        deps = self._deps.pop(t.seq, None)
        if deps and error is not None:
            for d in deps:
                if d.state != QUEUED or d.seq not in self._open:
                    continue
                sq = self._sqs.get(d.tenant)
                try:
                    sq.remove(d)
                except (ValueError, AttributeError):
                    continue             # pragma: no cover - defensive
                self.link_cancelled += 1
                self._bump("link_cancelled")
                self._finish_locked(d, error=LinkCancelledError(
                    f"ECANCELED: link parent ticket {t.tid} failed: "
                    f"{error!r}"))

    def _complete(self, t: Ticket, value=None, error=None) -> None:
        with self._cond:
            self._finish_locked(t, value=value, error=error)

    def _fail_queued_locked(self) -> None:
        err = self._dead
        for sq in self._sqs.values():
            while sq:
                self._finish_locked(sq.popleft(), error=SubmitError(
                    f"engine dead: {err!r}"))

    def _fatal(self, err: BaseException, t: Ticket) -> None:
        with self._cond:
            self._dead = err
            self._finish_locked(t, error=err)
            self._fail_queued_locked()

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            out = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "cancelled": self.cancelled,
                "open": len(self._open),
                "cq_depth": len(self._cq),
                "inflight": {k: v for k, v in self._inflight.items() if v},
                "workers": len(self._workers),
                "copies_avoided": self.copies_avoided,
                "bytes_pinned": self.bytes_pinned,
                "staging_copies": self.staging_copies,
                "staging_copy_bytes": self.staging_copy_bytes,
                "links_submitted": self.links_submitted,
                "link_cancelled": self.link_cancelled,
                "link_depth_max": self.link_depth_max,
            }
        if self.registry is not None:
            out["registry"] = self.registry.stats()
        return out

    def close(self, drain: bool = True) -> None:
        if drain and self._dead is None:
            try:
                self.drain(timeout=30.0)
            except (TimeoutError, SimulatedCrash):
                pass
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        for w in self._workers:
            w.join(timeout=5.0)


def hedged_read(vol, lba: int, *, delay_s: float, out=None, tenant=None,
                replica: int = 1):
    """Tail-tolerant replicated read over ``vol``'s async engine (shared
    by ``StripedVolume.hedged_read`` and ``ClusterVolume.hedged_read``):
    submit the primary read, wait ``delay_s``; if it has not completed,
    fire the SAME read against copy ``replica`` and take the first
    completion.  The loser is cancelled through the per-ticket cancel
    path — a QUEUED loser never dispatches, a RUNNING loser is
    discarded (its ``out=`` landing suppressed), and either way its
    pinned registered buffers go back to the pool from the completion
    path.  A winner that FAILED (fail-stop, not fail-slow) settles the
    other leg and serves it instead, so hedging subsumes failover.

    Counter contract (``Metrics.tail_path()``): every fired hedge
    retires as exactly ONE of ``hedges_won`` (the hedge's result was
    served) or ``hedges_cancelled`` (recalled, raced out by the primary,
    or failed) — ``hedges_fired == hedges_won + hedges_cancelled``."""
    eng = vol.aio_engine()
    m = vol.metrics
    m.bump("hedged_reads")
    primary = eng.submit("read", lba, tenant=tenant, out=out)
    try:
        eng.wait(primary, timeout=delay_s)
    except TimeoutError:
        pass
    if primary.done and primary.error is None:
        return primary.value          # fast path: no hedge fired
    hedge = eng.submit("read", lba, tenant=tenant, replica=replica)
    m.bump("hedges_fired")
    winner = eng.wait_any([primary, hedge])
    loser = hedge if winner is primary else primary
    if winner.error is not None:
        # the winner leg failed outright — settle the other leg and
        # serve it (fail-stop failover riding the hedge machinery)
        eng.wait(loser)
        winner, loser = loser, winner
    elif not eng.cancel(loser):
        # both-complete race: the loser finished before the cancel
        # reached it — consume its one CQE (never a double completion)
        eng.wait(loser)
    else:
        if loser is primary:
            m.bump("primaries_cancelled")
        if loser.done:
            # QUEUED-cancel completes immediately: consume the CQE so
            # the shared ring is not littered.  A RUNNING (discarded)
            # loser completes later — its one CancelledError CQE drains
            # on a normal poll; we never block on the slow leg
            eng.wait(loser)
    m.bump("hedges_won" if winner is hedge else "hedges_cancelled")
    if winner.error is not None:
        raise winner.error
    if winner is hedge and out is not None:
        # the hedge leg is submitted WITHOUT out= (two tickets must
        # never land the same caller array); a hedge win copies once
        # here — the cancelled primary's discard flag guarantees it
        # cannot touch the buffer afterwards
        arr = out.data if isinstance(out, RegisteredBuf) else out
        src = winner.value
        src = src.view(np.uint8).reshape(-1) \
            if isinstance(src, np.ndarray) \
            else np.frombuffer(memoryview(src), dtype=np.uint8)
        n = min(arr.size, src.size)
        arr[:n] = src[:n]
        return out
    return winner.value
