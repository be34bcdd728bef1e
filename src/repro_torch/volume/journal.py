"""Chained-transaction redo journal with group-committed checkpoints.

A shard's BTT makes each *single-block* write atomic (CoW + Flog), but a
logical write that spans shards has no such guarantee: a crash between the
per-shard writes leaves a torn multi-block write.  The volume closes the
gap with physical redo journaling built out of the atomicity primitive we
already have — one BTT block write.

Commit records (one journal slot each)
--------------------------------------
Every record header carries ``{magic, txid, lba, n_blocks, crc, chain_id,
seq, flags}``.  A logical write of up to ``span`` blocks is ONE record; a
larger write becomes a **chain** of records sharing a ``chain_id`` (the
chain's first txid) with consecutive ``seq`` numbers, the last one flagged
``CHAIN_TAIL``.  The commit protocol for a chain is:

  1. every link's payload blocks are written into its journal slot
     (direct to the slot shard's BTT, bypassing any staging cache);
  2. the non-tail headers are written next, grouped by slot shard so a
     multi-link chain costs one header pass per shard;
  3. the TAIL header is written LAST via one atomic BTT write.  That
     single block write is the commit point for the *whole chain*: a
     valid tail proves every earlier link is on media (headers are
     ordered), so recovery replays the chain whole — and a crash before
     the tail leaves the chain invisible (old object intact on every
     shard), because in-place writes only start after the tail lands.

This gives **whole-object atomicity** for arbitrarily large logical
writes (bounded by the ring: a chain may not exceed ``n_slots`` links)
without a blockstore-style root flip and without per-transaction-only
guarantees.  Legacy records written before chaining existed carry
``chain_id == 0`` and replay standalone, so old volumes reopen cleanly.

Recovery (:meth:`VolumeJournal.scan`) keeps a record iff its header is
valid, its txid is newer than the checkpointed ``applied`` txid, and its
chain is *complete* — all links present with the tail flagged.  Torn
in-place writes are rolled forward to the complete image; a chain whose
tail never landed is invisible.

Batched log pipeline
--------------------
``log_batch`` persists MANY chains in shared slot-shard passes — one txid
reservation, all payloads, all non-tail headers grouped per shard, then
every tail header in one final pass (each tail is still its own chain's
atomic commit point, so a crash inside the tail pass commits whole
members only, never a partial member chain).  :class:`LogBatcher` feeds
it: concurrent ``log()``/``write_multi`` callers elect a leader that
flushes the whole pending list under ONE volume ``_txlock`` acquisition
(``log_window`` gathers followers, mirroring ``commit_window``) — the
NVCache-style shared log that absorbs small-write bursts without
per-I/O journal stalls.

Checkpoints and group commit
----------------------------
``fsync`` checkpoints: after the caches drain, all journaled txids are
durable in place, so the applied mark advances and old slots are skipped
at recovery.  The volume wraps that checkpoint in a
:class:`GroupCommitter`: concurrent ``fsync`` callers elect one leader
that performs a single drain + one applied-mark superblock pass for the
whole batch (optionally waiting ``commit_window`` seconds to gather more
followers) — N tenants syncing together pay one header-write round trip
instead of N, the NVCache/van-Renen group-commit argument.

Slots are striped round-robin across shards so journal bandwidth scales
with the volume.
"""
from __future__ import annotations

import struct
import threading
import time
import zlib

import numpy as np

_JMAGIC = 0x10CA171          # "IO CAITI" journal
# magic, txid, lba, n_blocks, crc, chain_id, seq, flags
_HDR_FMT = "<QQQQQQQQ"
CHAIN_TAIL = 1               # flags bit: last link of its chain


class VolumeJournal:
    """Ring of ``n_slots`` redo slots striped over the shard BTTs.

    ``btts``      — one BTT per shard (journal I/O bypasses caches).
    ``base_lba``  — first shard-local lba of the journal region (the same
                    on every shard; the volume reserves the region).
    ``span``      — max payload blocks per record (slot size - 1); larger
                    logical writes chain multiple records.
    """

    def __init__(self, btts, *, base_lba: int, n_slots: int = 64,
                 span: int = 8, block_size: int = 4096) -> None:
        self.btts = list(btts)
        self.n_shards = len(self.btts)
        self.base_lba = base_lba
        self.n_slots = n_slots
        self.span = span
        self.block_size = block_size
        self.slot_blocks = 1 + span                    # header + payload
        self._lock = threading.Lock()
        self.next_txid = 1          # 0 means "nothing applied yet"
        self.applied_txid = 0       # persisted by the volume superblock
        self.chains_logged = 0

    # ------------------------------------------------------------ geometry
    def blocks_per_shard(self) -> int:
        slots_here = (self.n_slots + self.n_shards - 1) // self.n_shards
        return slots_here * self.slot_blocks

    def _slot_home(self, slot: int) -> tuple[int, int]:
        """(shard, shard-local lba of the slot's header block)."""
        shard = slot % self.n_shards
        local = slot // self.n_shards
        return shard, self.base_lba + local * self.slot_blocks

    def max_chain_blocks(self) -> int:
        """Largest logical write one chain can cover (ring bound)."""
        return self.n_slots * self.span

    # ------------------------------------------------------------- logging
    def _write_payload(self, txid: int, blocks) -> tuple[int, int, int]:
        """Write one record's payload into its slot; returns
        (shard, header lba, payload crc)."""
        slot = txid % self.n_slots
        shard, hdr_lba = self._slot_home(slot)
        btt = self.btts[shard]
        payload = b"".join(bytes(b) for b in blocks)
        crc = zlib.crc32(payload)
        for i, blk in enumerate(blocks):
            btt.write(hdr_lba + 1 + i, np.frombuffer(bytes(blk), np.uint8))
        return shard, hdr_lba, crc

    def _write_header(self, shard: int, hdr_lba: int, txid: int, lba: int,
                      n_blocks: int, crc: int, chain_id: int, seq: int,
                      flags: int) -> None:
        hdr = struct.pack(_HDR_FMT, _JMAGIC, txid, lba, n_blocks, crc,
                          chain_id, seq, flags)
        hdr = hdr + b"\x00" * (self.block_size - len(hdr))
        # one atomic BTT block write
        self.btts[shard].write(hdr_lba, np.frombuffer(hdr, np.uint8))

    def log(self, lba: int, blocks: list[bytes],
            checkpoint_cb=None) -> int:
        """Persist one single-record transaction; returns the committed
        txid.  Equivalent to a chain of length 1 (the header is flagged
        ``CHAIN_TAIL`` immediately, so it is the commit point)."""
        return self.log_chain(lba, blocks, checkpoint_cb=checkpoint_cb)[-1]

    def log_chain(self, lba: int, blocks, checkpoint_cb=None) -> list[int]:
        """Persist one logical write as a chain of records; returns the
        txids, tail last.  The write is committed — recovery will roll the
        WHOLE image forward — only once this returns (tail header landed);
        any earlier crash leaves it invisible.  A batch of one: see
        :meth:`log_batch` for the checkpoint-callback contract."""
        return self.log_batch([(lba, blocks)], checkpoint_cb=checkpoint_cb)[0]

    @staticmethod
    def _chunk_links(blocks, span: int) -> list[list[bytes]]:
        return [blocks[off:off + span] for off in range(0, len(blocks), span)]

    def log_batch(self, entries, checkpoint_cb=None,
                  apply_cb=None) -> list[list[int]]:
        """Persist MANY logical writes as batched slot-shard passes;
        returns one txid list (tail last) per entry, in entry order.

        ``entries`` is a sequence of ``(lba, blocks)`` pairs.  Each entry
        is its own chain (its own ``chain_id`` and its own tail commit
        point) but the batch shares the passes:

          1. ONE txid reservation under the journal lock for the whole
             group (instead of one per call);
          2. every entry's payload blocks into their slots;
          3. ALL non-tail headers of the batch, one pass per slot shard;
          4. ALL tail headers, one final pass per slot shard — written
             strictly after every non-tail header of the batch, so each
             member chain is complete on media before ANY member commits.

        Crash semantics per member are unchanged from :meth:`log_chain`:
        a member whose tail landed replays whole; a member whose tail
        did not land is invisible (its old image intact).  A crash inside
        the tail pass commits some members and not others — but NEVER a
        partial member chain, because phase 3 ordered all of its links
        onto media first.

        A batch whose total links exceed the ring is split into
        consecutive sub-groups that fit (each group <= ``n_slots`` links;
        a single oversized entry still asserts, as ``log_chain`` did).
        ``apply_cb(entry_index, txids)`` is invoked for every member of a
        group as soon as that group's tails are on media and BEFORE the
        next group journals: a later group may reuse the earlier group's
        slots (and its ring-wrap checkpoint will mark them applied), so
        the earlier members' in-place writes must already be issued —
        exactly the ordering sequential ``log_chain`` calls had.  The
        caller that applies AFTER ``log_batch`` returns (no ``apply_cb``)
        must only pass batches that fit one group.

        ``checkpoint_cb(upto)`` is invoked when the ring wraps onto slots
        whose previous occupants have not been checkpointed yet — the
        volume drains its caches and advances ``applied_txid``.  The
        callback receives an upper bound strictly below the group's first
        txid: marking any chain of the CURRENT group applied before its
        in-place writes happen would let a crash skip the replay and
        surface a torn object (earlier groups are already applied via
        ``apply_cb``).
        """
        ents = []
        for lba, blocks in entries:
            blocks = [bytes(b) for b in blocks]
            assert blocks, "empty transaction"
            links = self._chunk_links(blocks, self.span)
            assert len(links) <= self.n_slots, \
                f"chain of {len(links)} links exceeds the {self.n_slots}-" \
                f"slot ring (max {self.max_chain_blocks()} blocks per " \
                f"logical write)"
            ents.append((lba, links))
        results: list[list[int] | None] = [None] * len(ents)
        i = 0
        while i < len(ents):
            group, total = [], 0
            while i < len(ents) and (not group
                                     or total + len(ents[i][1])
                                     <= self.n_slots):
                group.append(i)
                total += len(ents[i][1])
                i += 1
            self._log_group([ents[g] for g in group], group, results,
                            checkpoint_cb)
            if apply_cb is not None:
                for g in group:
                    apply_cb(g, results[g])
        return results

    def _log_group(self, group, idxs, results, checkpoint_cb) -> None:
        """One batched slot-shard pass for a group of chains whose links
        fit the ring together."""
        n_links = sum(len(links) for _, links in group)
        with self._lock:
            first = self.next_txid
            self.next_txid += n_links
            last = first + n_links - 1
            # slots for txids (last - n_slots, last] are about to be
            # reused; everything at or below last - n_slots must be
            # checkpointed first.  The checkpoint drains every cache, so
            # marking applied up to first - 1 is safe — but never the
            # group itself (its in-place writes have not happened yet)
            need_ckpt = last > self.n_slots \
                and last - self.n_slots > self.applied_txid
        if need_ckpt and checkpoint_cb is not None:
            checkpoint_cb(first - 1)
        # phase 1: all payloads, every entry of the batch
        txid = first
        per_entry = []          # [(txid, lba, n, shard, hdr_lba, crc,
        for lba, links in group:                        # chain_id, seq)]
            chain_id = txid
            homes = []
            off = 0
            for seq, link in enumerate(links):
                shard, hdr_lba, crc = self._write_payload(txid, link)
                homes.append((txid, lba + off, len(link), shard, hdr_lba,
                              crc, chain_id, seq))
                off += len(link)
                txid += 1
            per_entry.append(homes)
        # phase 2: non-tail headers of the WHOLE batch, one pass per shard
        body = [h for homes in per_entry for h in homes[:-1]]
        for shard in sorted({h[3] for h in body}):
            for (txid, blk, n, s, hdr_lba, crc, chain_id, seq) in body:
                if s == shard:
                    self._write_header(s, hdr_lba, txid, blk, n, crc,
                                       chain_id, seq, 0)
        # phase 3: the commit points — every tail header, one final pass
        # per slot shard, written after all of phase 2 (each member chain
        # is wholly on media before any member becomes committed)
        tails = [homes[-1] for homes in per_entry]
        for shard in sorted({h[3] for h in tails}):
            for (txid, blk, n, s, hdr_lba, crc, chain_id, seq) in tails:
                if s == shard:
                    self._write_header(s, hdr_lba, txid, blk, n, crc,
                                       chain_id, seq, CHAIN_TAIL)
        with self._lock:
            self.chains_logged += len(group)
        for k, homes in zip(idxs, per_entry):
            results[k] = [h[0] for h in homes]

    def mark_applied(self, txid: int) -> None:
        with self._lock:
            self.applied_txid = max(self.applied_txid, txid)

    def last_txid(self) -> int:
        with self._lock:
            return self.next_txid - 1

    # ------------------------------------------------------------ recovery
    def scan(self) -> list[tuple[int, int, list[bytes]]]:
        """All committed records newer than ``applied_txid``:
        (txid, lba, blocks), sorted ascending by txid.

        A record is committed iff its header+payload are valid AND its
        chain is complete: every link (seq 0..tail) present under the
        same ``chain_id`` with the tail flagged.  Legacy records
        (``chain_id == 0``, written before chaining) replay standalone.
        """
        hdr_len = struct.calcsize(_HDR_FMT)
        records = []                 # (txid, lba, blocks, chain_id, seq, fl)
        for slot in range(self.n_slots):
            shard, hdr_lba = self._slot_home(slot)
            btt = self.btts[shard]
            raw = bytes(btt.read(hdr_lba)[:hdr_len])
            magic, txid, lba, n_blocks, crc, chain_id, seq, flags = \
                struct.unpack(_HDR_FMT, raw)
            if magic != _JMAGIC or txid <= self.applied_txid:
                continue
            if not 0 < n_blocks <= self.span:
                continue
            blocks = [bytes(btt.read(hdr_lba + 1 + i))
                      for i in range(n_blocks)]
            if zlib.crc32(b"".join(blocks)) != crc:
                continue                 # torn journal write: not committed
            records.append((txid, lba, blocks, chain_id, seq, flags))
        # chain completeness: keep standalone/legacy records; keep chain
        # links only when the whole chain made it (tail header landed)
        by_chain: dict[int, list] = {}
        for rec in records:
            by_chain.setdefault(rec[3], []).append(rec)
        found = []
        for chain_id, recs in by_chain.items():
            if chain_id == 0:            # legacy: each record standalone
                found.extend(recs)
                continue
            recs.sort(key=lambda r: r[4])
            tail = recs[-1]
            complete = (tail[5] & CHAIN_TAIL) \
                and [r[4] for r in recs] == list(range(len(recs))) \
                and [r[0] for r in recs] == [chain_id + i
                                             for i in range(len(recs))]
            if complete:
                found.extend(recs)
        found.sort(key=lambda r: r[0])
        return [(txid, lba, blocks) for txid, lba, blocks, *_ in found]


class GroupCommitter:
    """Leader/follower coalescing for ``fsync``-style commits.

    ``sync()`` guarantees that one full commit (``commit_fn``) starts
    after the call and completes before it returns — but N concurrent
    callers share ONE commit: the first becomes leader, optionally waits
    ``window`` seconds for more followers, then runs ``commit_fn`` once
    for the whole batch.  Followers whose request predates the commit's
    start simply wait for it.  With ``window == 0`` there is no added
    latency and purely-concurrent callers still coalesce.
    """

    def __init__(self, commit_fn, window: float = 0.0) -> None:
        self._commit_fn = commit_fn
        self.window = window
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._seq = 0                # requests issued
        self._completed = 0          # highest request covered by a commit
        self._leader = False
        # failed batches as (low, high, err) request ranges: an error is
        # delivered ONLY to the callers whose requests that commit
        # covered, never leaked to a later batch's waiters
        self._failed: list[tuple[int, int, BaseException]] = []
        self.commits = 0             # commit_fn invocations
        self.calls = 0               # sync() invocations

    def _batch_error(self, req: int) -> BaseException | None:
        for low, high, err in self._failed:
            if low <= req <= high:
                return err
        return None

    def sync(self) -> bool:
        """Returns True when this caller led the commit, False when it
        coalesced onto another caller's."""
        with self._cond:
            self.calls += 1
            self._seq += 1
            my_req = self._seq
            while True:
                if self._completed >= my_req:
                    err = self._batch_error(my_req)
                    if err is not None:
                        raise err
                    return False
                if not self._leader:
                    self._leader = True
                    break
                self._cond.wait(timeout=0.5)
        # ---- leader: gather, commit once for everyone <= batch_high
        err = None
        try:
            if self.window > 0:
                time.sleep(self.window)
            with self._lock:
                batch_high = self._seq
            try:
                self._commit_fn()
            except BaseException as e:      # propagate to the whole batch
                err = e
            with self._cond:
                self.commits += 1
                if err is not None:
                    self._failed.append(
                        (self._completed + 1, batch_high, err))
                    if len(self._failed) > 64:     # bound the history
                        self._failed.pop(0)
                self._completed = max(self._completed, batch_high)
        finally:
            with self._cond:
                self._leader = False
                self._cond.notify_all()
        if err is not None:
            raise err
        return True

    def stats(self) -> dict:
        with self._lock:
            return {"calls": self.calls, "commits": self.commits,
                    "coalesced": self.calls - self.commits}


class LogEntry:
    """One logical write riding a :class:`LogBatcher` batch."""

    __slots__ = ("lba", "blocks", "tenant", "txids", "error", "done")

    def __init__(self, lba: int, blocks, tenant=None) -> None:
        self.lba = lba
        self.blocks = blocks
        self.tenant = tenant
        self.txids: list[int] | None = None
        self.error: BaseException | None = None
        self.done = False

    @property
    def nbytes(self) -> int:
        return sum(len(b) for b in self.blocks)


class LogBatcher:
    """Leader/follower coalescing for chained-tx ``log()`` payload writes.

    The group committer (above) coalesces *fsyncs*; this coalesces the
    **log writes themselves**.  Without it every ``write_multi`` chain
    serializes its own slot-shard pass under the volume ``_txlock`` —
    N concurrent small logged writes pay N lock acquisitions, N header
    passes and N tail fences.  With it, concurrent ``submit()`` callers
    elect a leader that (optionally after gathering ``window`` seconds,
    the ``log_window`` knob mirroring ``commit_window``) hands the WHOLE
    pending list to ``flush_fn`` in one go: one ``_txlock`` acquisition,
    headers grouped per slot shard across the batch, one tail pass per
    batch (see :meth:`VolumeJournal.log_batch`) — the NVCache-style
    shared-log batching of small durable writes.

    ``flush_fn(entries)`` journals + applies every entry (setting
    ``entry.txids``); an exception it raises is delivered to exactly the
    callers whose entries were in that batch, never leaked to a later
    batch.  ``submit()`` returns the entry's txids once its batch has
    fully committed AND applied in place — same post-condition as a
    direct ``log_chain`` + in-place pass.
    """

    def __init__(self, flush_fn, window: float = 0.0) -> None:
        self._flush_fn = flush_fn
        self.window = window
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: list[LogEntry] = []
        self._leader = False
        self.calls = 0               # submit() invocations
        self.batches = 0             # flush_fn invocations
        self.batched_entries = 0     # entries flushed (== calls, eventually)
        self.max_batch = 0

    def submit(self, lba: int, blocks, tenant=None) -> list[int]:
        entry = LogEntry(lba, blocks, tenant)
        with self._cond:
            self.calls += 1
            self._pending.append(entry)
            while True:
                if entry.done:
                    if entry.error is not None:
                        raise entry.error
                    return entry.txids
                if not self._leader:
                    self._leader = True
                    break
                self._cond.wait(timeout=0.5)
        # ---- leader: gather, flush the whole pending list in one pass
        try:
            if self.window > 0:
                time.sleep(self.window)
            with self._lock:
                batch, self._pending = self._pending, []
            err = None
            try:
                self._flush_fn(batch)
            except BaseException as e:   # delivered to THIS batch only
                err = e
            with self._cond:
                self.batches += 1
                self.batched_entries += len(batch)
                self.max_batch = max(self.max_batch, len(batch))
                for b in batch:
                    b.error = err
                    b.done = True
        finally:
            with self._cond:
                self._leader = False
                self._cond.notify_all()
        if entry.error is not None:
            raise entry.error
        return entry.txids

    def stats(self) -> dict:
        with self._lock:
            return {"calls": self.calls, "batches": self.batches,
                    "coalesced": self.batched_entries - self.batches,
                    "max_batch": self.max_batch}
