"""Block Translation Table — faithful re-implementation of the kernel driver.

Semantics reproduced from the paper (Section 2.2, Figure 1) and the kernel
documentation it cites:

* The PMem space is split into *arenas*; each arena holds two redundant Info
  blocks, a *map* (lba -> pba), a *Flog* (per-lane redo log, two alternating
  slots per lane), and data blocks.
* ``nfree`` lanes (min(n_cores, 256)); each lane owns one free block.
* A write is CoW: (1) take the lane, (2) write payload into the lane's free
  block, (3) append a Flog entry (lba, old_pba, new_pba, seq), (4) commit by
  the 8-byte atomic map update, (5) the old pba becomes the lane's free block.
* Crash recovery replays the Flog: an entry whose map slot does not equal its
  ``new_pba`` denotes an uncommitted write — the lba still maps to the old,
  complete block; the (possibly torn) free block is simply reused.  This is
  the block-level write atomicity that Caiti must not break.

All BTT metadata lives *inside* the PMemSpace so that file-backed pools give
real crash recovery across process restarts.
"""
from __future__ import annotations

import os
import threading

import numpy as np

from .pmem import PMemSpace

_INFO_MAGIC = 0xB77B77B7
_FLOG_SLOTS = 2          # alternating flog pairs, as in kernel BTT
_FLOG_ENTRY_U64 = 4      # lba, old_pba, new_pba, seq


class BTT:
    """One-arena BTT device on top of a PMemSpace.

    Layout (in blocks):  [info | map | flog | data ...]
    ``n_lbas`` external blocks are served from ``n_lbas + nfree`` data blocks.
    """

    def __init__(self, pmem: PMemSpace, n_lbas: int, nfree: int | None = None,
                 fresh: bool = True) -> None:
        self.pmem = pmem
        self.block_size = pmem.block_size
        self.n_lbas = int(n_lbas)
        self.nfree = int(nfree or min(os.cpu_count() or 8, 256))
        if not fresh:
            # geometry is authoritative from the pool's info block
            assert pmem.load_u64(0) == _INFO_MAGIC, "not a BTT pool"
            self.n_lbas = pmem.load_u64(8)
            self.nfree = pmem.load_u64(16)
        self._compute_layout()
        self._init_runtime()
        self.recovery_stats: dict = {}
        if fresh:
            self._format()
        else:
            self.recovery_stats = self.recover()

    def _compute_layout(self) -> None:
        map_bytes = self.n_lbas * 8
        flog_bytes = self.nfree * _FLOG_SLOTS * _FLOG_ENTRY_U64 * 8
        bs = self.block_size
        self._map_off = bs                                   # after info block
        self._flog_off = self._map_off + ((map_bytes + bs - 1) // bs) * bs
        data_off = self._flog_off + ((flog_bytes + bs - 1) // bs) * bs
        self._data_base = data_off // bs                      # first data pba
        need = self._data_base + self.n_lbas + self.nfree
        assert need <= self.pmem.n_blocks, (
            f"PMem too small: need {need} blocks, have {self.pmem.n_blocks}")

    def _init_runtime(self) -> None:
        self._nstripes = 1024
        self._stripes = [threading.Lock() for _ in range(self._nstripes)]
        self._lane_locks = [threading.Lock() for _ in range(self.nfree)]
        self._lane_free = [0] * self.nfree   # internal pba per lane
        self._lane_seq = [0] * self.nfree    # flog sequence per lane
        self._lane_rr = 0
        self.writes = 0
        self.reads = 0

    # ------------------------------------------------------------- metadata
    def _map_cell(self, lba: int) -> int:
        return self._map_off + lba * 8

    def _flog_cell(self, lane: int, slot: int, field: int) -> int:
        return (self._flog_off
                + ((lane * _FLOG_SLOTS + slot) * _FLOG_ENTRY_U64 + field) * 8)

    def _format(self) -> None:
        p = self.pmem
        p.store_u64(0, _INFO_MAGIC)
        p.store_u64(8, self.n_lbas)
        p.store_u64(16, self.nfree)
        # identity map: lba i -> internal block i
        for lba in range(self.n_lbas):
            p.store_u64(self._map_cell(lba), lba)
        # free blocks are the tail blocks; seed flog as the kernel does:
        # lba=0, old=new=free, seq=1.  On recovery map[0] != new, so the
        # lane's free block is re-derived as ``new`` — correct and benign.
        for lane in range(self.nfree):
            free = self.n_lbas + lane
            self._lane_free[lane] = free
            self._lane_seq[lane] = 1
            self._write_flog(lane, slot=1 % _FLOG_SLOTS, lba=0,
                             old=free, new=free, seq=1)
        p.persist()

    def _load_map(self, lba: int) -> int:
        return self.pmem.load_u64(self._map_cell(lba))

    def _store_map(self, lba: int, pba: int) -> None:
        # THE commit point: one 8-byte atomic store (kernel BTT does the same).
        self.pmem.store_u64(self._map_cell(lba), pba)

    def _write_flog(self, lane: int, slot: int, lba: int, old: int, new: int,
                    seq: int) -> None:
        p = self.pmem
        p.store_u64(self._flog_cell(lane, slot, 0), lba)
        p.store_u64(self._flog_cell(lane, slot, 1), old)
        p.store_u64(self._flog_cell(lane, slot, 2), new)
        # seq written last — it validates the entry
        p.store_u64(self._flog_cell(lane, slot, 3), seq)

    def _read_flog(self, lane: int, slot: int) -> tuple[int, int, int, int]:
        p = self.pmem
        return tuple(p.load_u64(self._flog_cell(lane, slot, f))  # type: ignore
                     for f in range(4))

    # ---------------------------------------------------------------- I/O
    def pick_lane(self) -> int:
        """Kernel BTT uses the CPU id; we round-robin across lanes."""
        self._lane_rr = (self._lane_rr + 1) % self.nfree
        return self._lane_rr

    def write(self, lba: int, data, lane: int | None = None) -> None:
        """Atomic block write via CoW + Flog (paper Fig. 1 steps 1-4)."""
        assert 0 <= lba < self.n_lbas
        if lane is None:
            lane = self.pick_lane()
        lane_lock = self._lane_locks[lane % self.nfree]
        stripe = self._stripes[lba % self._nstripes]
        with lane_lock:
            lane = lane % self.nfree
            free = self._lane_free[lane]
            # (2) CoW: payload goes to the lane's free block first
            self.pmem.write_block(self._data_base + free, data)
            with stripe:
                old = self._load_map(lba)
                seq = self._lane_seq[lane] + 1
                # (3) redo log the mapping change
                self._write_flog(lane, slot=seq % _FLOG_SLOTS, lba=lba,
                                 old=old, new=free, seq=seq)
                # (4) commit: 8-byte atomic map update
                self._store_map(lba, free)
                self._lane_seq[lane] = seq
            # (5) the swapped-out block replenishes the lane
            self._lane_free[lane] = old
        self.writes += 1

    def read(self, lba: int, out: np.ndarray | None = None) -> np.ndarray:
        assert 0 <= lba < self.n_lbas
        stripe = self._stripes[lba % self._nstripes]
        with stripe:
            pba = self._load_map(lba)
            buf = self.pmem.read_block(self._data_base + pba, out=out)
        self.reads += 1
        return buf

    def flush(self) -> None:
        """BTT has no volatile state for data; persist the pool (msync)."""
        self.pmem.persist()

    # ------------------------------------------------------------- recovery
    def recover(self) -> dict:
        """Replay the Flog after a crash (kernel ``btt_freelist_init`` logic).

        A valid flog entry is only written *after* its data block is fully
        persisted, so recovery **rolls forward**: if the map still shows
        ``old_pba`` the 8-byte commit was lost and we redo it.  If the map
        shows anything else (``new_pba`` already, or an even newer pba from
        another lane's later write to the same lba) we leave it alone.  The
        lane's free block is always the entry's ``old_pba``.
        """
        p = self.pmem
        assert p.load_u64(0) == _INFO_MAGIC, "not a BTT pool"
        if (p.load_u64(8), p.load_u64(16)) != (self.n_lbas, self.nfree):
            # pool geometry differs from the constructor's guess: re-derive
            self.n_lbas = p.load_u64(8)
            self.nfree = p.load_u64(16)
            self._compute_layout()
            self._init_runtime()
        redone = 0
        clean = 0
        for lane in range(self.nfree):
            entries = [self._read_flog(lane, s) for s in range(_FLOG_SLOTS)]
            # newest valid entry wins (seq written last validates an entry;
            # a torn entry keeps its stale, lower seq and loses here)
            lba, old, new, seq = max(entries, key=lambda e: e[3])
            self._lane_seq[lane] = seq
            self._lane_free[lane] = old if old != new else new
            if old == new:
                clean += 1          # freshly formatted / untouched lane
                continue
            cur = self._load_map(lba)
            if cur == old:
                # commit was lost mid-flight: data is complete (flog entry is
                # valid ⇒ payload persisted first) — roll the map forward.
                self._store_map(lba, new)
                redone += 1
            else:
                clean += 1
        p.persist()
        return {"redone_lanes": redone, "clean_lanes": clean}
