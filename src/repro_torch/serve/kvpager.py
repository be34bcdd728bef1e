"""Volume-backed KV spill tier — the serving plane's BTT free-block pool.

The host tier in :mod:`repro_torch.serve.kvcache` is a plain in-memory dict, so
session KV is bounded by DRAM.  This pager extends the tier hierarchy one
level down onto the async striped volume, re-using the storage stack the
paper's transit discipline already built:

  chained ``write_multi``   -> one spilled page is ONE atomic record (the
                               chained-tx journal commits the whole block
                               list or none of it — no torn KV pages)
  crc ledger                -> every record carries a wire crc32 over the
                               packed payload, verified on restore before
                               the page re-enters the host tier (the fused
                               transit-kernel checksums then re-verify the
                               int8 payload end to end on page-in)
  linked async reads        -> ``prefetch()`` issues a record's block
                               reads as an IO_LINK chain ahead of
                               ``activate()`` so the restore overlaps
                               decode (the aio qd curve's >= 1.5x)
  write-crc dedup           -> records are content-addressed (blake2b over
                               the payload): prefix-shared pages spill
                               once and share a refcounted slot

``volume`` is anything speaking the async surface — a ``StripedVolume``
or a ``repro_torch.cluster.ClusterVolume`` (replicated KV spill that survives
node loss).  Records are fixed-size slots carved out of
``[base_lba, base_lba + capacity_blocks)``; the slot size is learned from
the first spill (every page of one cache packs to the same length) and
bounded by the device's ``max_atomic_write_blocks()``.
"""
from __future__ import annotations

import hashlib
import threading
import zlib

import numpy as np

from repro_torch.core.metrics import Metrics

_HDR = 8                      # 4B payload length + 4B crc32, little-endian


class _Record:
    __slots__ = ("slot", "lba", "n_blocks", "key", "refs",
                 "spill_tickets", "pf_tickets")

    def __init__(self, slot: int, lba: int, n_blocks: int, key: bytes):
        self.slot = slot
        self.lba = lba
        self.n_blocks = n_blocks
        self.key = key
        self.refs = 1
        self.spill_tickets: list = []      # settled before any read
        self.pf_tickets: list | None = None   # in-flight prefetch chain


class KVPager:
    """Content-addressed, refcounted page records on an async volume."""

    def __init__(self, volume, *, base_lba: int = 0,
                 capacity_blocks: int | None = None,
                 tenant: str | None = None,
                 metrics: Metrics | None = None) -> None:
        self.vol = volume
        self.tenant = tenant
        # a pager built without explicit metrics is adopted into its
        # cache's Metrics when attached (PagedKVCache.__init__), so the
        # kv_* counters land next to the serve-plane ones
        self.own_metrics = metrics is None
        self.metrics = metrics or Metrics()
        self.block_size = volume.block_size
        self._max_rec = (volume.max_atomic_write_blocks()
                         if hasattr(volume, "max_atomic_write_blocks")
                         else None)
        self._base = base_lba
        self._cap = (volume.n_lbas - base_lba if capacity_blocks is None
                     else capacity_blocks)
        assert self._cap >= 1
        self._lock = threading.Lock()
        self._slot_blocks: int | None = None   # fixed after first spill
        self._free_slots: list[int] = []
        self._n_slots = 0
        self._records: dict[int, _Record] = {}   # handle -> record
        self._by_key: dict[bytes, int] = {}      # content hash -> handle
        self._next_handle = 0                    # handles never reused

    # ------------------------------------------------------------ geometry
    def _blocks_for(self, payload_len: int) -> int:
        return -(-(_HDR + payload_len) // self.block_size)

    def _init_slots(self, n_blocks: int) -> None:
        assert self._max_rec is None or n_blocks <= self._max_rec, \
            (f"KV page record of {n_blocks} blocks exceeds the device's "
             f"whole-object-atomic bound ({self._max_rec})")
        self._slot_blocks = n_blocks
        self._n_slots = self._cap // n_blocks
        assert self._n_slots >= 1, "spill region smaller than one KV page"
        self._free_slots = list(range(self._n_slots))

    def _slot_lba(self, slot: int) -> int:
        return self._base + slot * self._slot_blocks

    def free_slots(self) -> int:
        with self._lock:
            return (self._n_slots if self._slot_blocks is None
                    else len(self._free_slots))

    # --------------------------------------------------------------- spill
    def spill(self, payload: bytes) -> int:
        """Write one packed page to the volume (or dedup against a live
        record with the same content); returns a refcounted handle."""
        key = hashlib.blake2b(payload, digest_size=16).digest()
        with self._lock:
            h = self._by_key.get(key)
            if h is not None:
                self._records[h].refs += 1
                self.metrics.bump("kv_dedup_hits")
                return h
            n_blocks = self._blocks_for(len(payload))
            if self._slot_blocks is None:
                self._init_slots(n_blocks)
            assert n_blocks <= self._slot_blocks, \
                "KV page packed larger than the pager's slot size"
            if not self._free_slots:
                raise MemoryError(
                    f"KV spill tier exhausted ({self._n_slots} slots of "
                    f"{self._slot_blocks} blocks); grow capacity_blocks "
                    f"or release sequences")
            slot = self._free_slots.pop()
            h = self._next_handle
            self._next_handle += 1
            rec = _Record(slot, self._slot_lba(slot), n_blocks, key)
            self._records[h] = rec
            self._by_key[key] = h
            # whole-record atomicity: one chained write_multi per page
            # (block=True: a spill burst deeper than the engine window
            # waits its turn — a page is never silently dropped)
            wire = (len(payload).to_bytes(4, "little")
                    + zlib.crc32(payload).to_bytes(4, "little") + payload)
            bs = self.block_size
            blocks = [np.frombuffer(
                wire[i:i + bs].ljust(bs, b"\x00"), np.uint8)
                for i in range(0, len(wire), bs)]
            if len(blocks) > 1:
                t = self.vol.submit("write_multi", rec.lba, blocks=blocks,
                                    tenant=self.tenant, block=True)
            else:
                t = self.vol.submit("write", rec.lba, data=blocks[0],
                                    tenant=self.tenant, block=True)
            rec.spill_tickets.append(t)
            self.metrics.bump("kv_spills")
            self.metrics.bump("kv_spill_blocks", rec.n_blocks)
            return h

    # ------------------------------------------------------------ prefetch
    def prefetch(self, handles) -> int:
        """Decode-ahead restore: issue each record's block reads as a
        linked async chain (IO_LINK) so the data is in flight before
        ``activate()`` needs it.  Best-effort — a full submission window
        skips the handle (the sync path still works).  Returns how many
        chains were issued."""
        issued = 0
        for h in handles:
            with self._lock:
                rec = self._records.get(h)
                if rec is None or rec.pf_tickets is not None:
                    continue
                for t in rec.spill_tickets:     # record must be durable
                    self.vol.wait(t)
                rec.spill_tickets = []
                tickets: list = []
                prev = None
                for i in range(rec.n_blocks):
                    t = self.vol.try_submit("read", rec.lba + i,
                                            tenant=self.tenant,
                                            link_to=prev)
                    if t is None:               # window full: back off
                        for tt in tickets:
                            self._cancel(tt)
                        tickets = []
                        break
                    tickets.append(t)
                    prev = t
                if tickets:
                    rec.pf_tickets = tickets
                    issued += 1
                    self.metrics.bump("kv_prefetch_issued")
        return issued

    # --------------------------------------------------------------- fetch
    def fetch(self, handle: int) -> bytes:
        """Read one record back (prefetched payload if the decode-ahead
        chain landed, synchronous reads otherwise), verify the wire crc,
        and return the packed payload.  The record stays live — pair
        with :meth:`release` once the page is resident again."""
        with self._lock:
            rec = self._records[handle]
            spills, rec.spill_tickets = rec.spill_tickets, []
            pf, rec.pf_tickets = rec.pf_tickets, None
        for t in spills:                        # settle the write first
            self.vol.wait(t)
            if t.error is not None:
                raise t.error
        raw = None
        if pf is not None:
            ok = True
            parts = []
            for t in pf:
                self.vol.wait(t)
                if t.error is not None:         # link cancelled / device
                    ok = False
                else:
                    parts.append(self._as_bytes(t.value))
            if ok:
                raw = b"".join(parts)
                self.metrics.bump("kv_prefetch_hits")
        if raw is None:                         # sync restore path
            parts = []
            for i in range(rec.n_blocks):
                t = self.vol.submit("read", rec.lba + i,
                                    tenant=self.tenant, block=True)
                self.vol.wait(t)
                if t.error is not None:
                    raise t.error
                parts.append(self._as_bytes(t.value))
            raw = b"".join(parts)
        n = int.from_bytes(raw[:4], "little")
        crc = int.from_bytes(raw[4:8], "little")
        payload = raw[_HDR:_HDR + n]
        if len(payload) != n or zlib.crc32(payload) != crc:
            self.metrics.bump("kv_restore_crc_errors")
            raise IOError(
                f"KV spill record {handle} failed its wire checksum on "
                f"restore (lba {rec.lba}, {rec.n_blocks} blocks)")
        self.metrics.bump("kv_restores")
        return payload

    def _cancel(self, t) -> None:
        """Best-effort cancel + settle (the facade only exposes cancel
        through the engine; an already-running op just completes)."""
        eng = getattr(self.vol, "aio_engine", None)
        if eng is not None:
            eng().cancel(t)
        self.vol.wait(t)

    @staticmethod
    def _as_bytes(val) -> bytes:
        if isinstance(val, np.ndarray):
            return val.view(np.uint8).tobytes()
        return bytes(val)

    # -------------------------------------------------------------- release
    def release(self, handle: int) -> None:
        """Drop one reference; the last release frees the slot (and
        drops any unconsumed prefetch as wasted)."""
        with self._lock:
            rec = self._records[handle]
            rec.refs -= 1
            if rec.refs > 0:
                return
            del self._records[handle]
            del self._by_key[rec.key]
            pf, rec.pf_tickets = rec.pf_tickets, None
        if pf is not None:
            for t in pf:
                self._cancel(t)
            self.metrics.bump("kv_prefetch_wasted")
        for t in rec.spill_tickets:
            self.vol.wait(t)
        with self._lock:
            self._free_slots.append(rec.slot)
        self.metrics.bump("kv_spill_frees")

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {"records": len(self._records),
                    "slot_blocks": self._slot_blocks or 0,
                    "n_slots": self._n_slots,
                    "free_slots": (self._n_slots
                                   if self._slot_blocks is None
                                   else len(self._free_slots))}
