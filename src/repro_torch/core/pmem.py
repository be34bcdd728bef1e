"""PMem space emulation: a block-addressed persistent byte pool.

Two backends:
  * ``ram``  — a numpy byte buffer (fast; used by tests & latency studies).
  * ``file`` — an mmap'd file (used by the checkpoint engine so data really
               persists across process crashes).

Latency model
-------------
The container has no Optane DIMMs, so we inject the *relative* costs the paper
relies on. Numbers follow the paper's cited measurement study (Yang et al.,
FAST'20 [82]): PMem sequential write bandwidth is roughly 1/3 of DRAM, read
roughly 1/2–1/3, and the device's internal access granularity is 256 B.  The
emulation adds a busy-wait on top of the real memcpy so that *concurrency
behaviour is real* (GIL is released during numpy copies; background eviction
genuinely overlaps) while *ratios are faithful*.  All rates are configurable;
benchmarks state the model next to every result.
"""
from __future__ import annotations

import mmap
import os
import time
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class LatencyModel:
    """Per-medium bandwidth/latency injection. Set a bandwidth to 0 to disable."""

    pmem_write_gbps: float = 2.0    # Optane AppDirect ~2.3 GB/s/DIMM streaming write
    pmem_read_gbps: float = 6.0     # ~6.6 GB/s/DIMM read
    dram_gbps: float = 0.0          # real memcpy only (DRAM is the fast tier)
    pmem_write_fixed_ns: int = 300  # media write latency floor (ns)
    pmem_read_fixed_ns: int = 170   # load latency floor (ns)
    access_granularity: int = 256   # Optane internal block (write amplification)

    def write_delay_ns(self, nbytes: int) -> int:
        if self.pmem_write_gbps <= 0:
            return 0
        # round up to the 256B access granularity (write amplification)
        g = self.access_granularity
        eff = ((nbytes + g - 1) // g) * g
        return self.pmem_write_fixed_ns + int(eff / self.pmem_write_gbps)

    def read_delay_ns(self, nbytes: int) -> int:
        if self.pmem_read_gbps <= 0:
            return 0
        g = self.access_granularity
        eff = ((nbytes + g - 1) // g) * g
        return self.pmem_read_fixed_ns + int(eff / self.pmem_read_gbps)


NO_LATENCY = LatencyModel(pmem_write_gbps=0.0, pmem_read_gbps=0.0,
                          pmem_write_fixed_ns=0, pmem_read_fixed_ns=0)


def _busy_wait_ns(ns: int) -> None:
    if ns <= 0:
        return
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


class PMemSpace:
    """A persistent pool of ``n_blocks`` blocks of ``block_size`` bytes.

    Crash injection: ``crash_hook`` (if set) is invoked with a label before and
    mid-way through every store; raising ``SimulatedCrash`` there models a
    power failure, potentially leaving a *torn block* — which is exactly what
    BTT's CoW must tolerate.
    """

    def __init__(self, n_blocks: int, block_size: int = 4096,
                 backend: str = "ram", path: str | None = None,
                 latency: LatencyModel = NO_LATENCY) -> None:
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.latency = latency
        self.backend = backend
        self.path = path
        self.crash_hook = None  # callable(label: str) -> None
        nbytes = self.n_blocks * self.block_size
        if backend == "ram":
            self._buf = np.zeros(nbytes, dtype=np.uint8)
            self._mm = None
        elif backend == "file":
            assert path is not None
            self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            os.ftruncate(self._fd, nbytes)
            self._mm = mmap.mmap(self._fd, nbytes)
            self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        else:
            raise ValueError(f"unknown backend {backend}")

    # ------------------------------------------------------------------ I/O
    def write_block(self, pba: int, data) -> None:
        """Store one block. Honors the latency model and crash hook."""
        assert 0 <= pba < self.n_blocks, f"pba {pba} out of range"
        src = np.frombuffer(data, dtype=np.uint8)
        assert src.nbytes <= self.block_size
        off = pba * self.block_size
        if self.crash_hook is not None:
            self.crash_hook("pmem_write_begin")
            # model a torn write: copy only the first half, then crash check
            half = src.nbytes // 2
            self._buf[off:off + half] = src[:half]
            self.crash_hook("pmem_write_mid")
            self._buf[off + half:off + src.nbytes] = src[half:]
        else:
            self._buf[off:off + src.nbytes] = src
        _busy_wait_ns(self.latency.write_delay_ns(src.nbytes))

    def read_block(self, pba: int, out: np.ndarray | None = None) -> np.ndarray:
        assert 0 <= pba < self.n_blocks
        off = pba * self.block_size
        view = self._buf[off:off + self.block_size]
        _busy_wait_ns(self.latency.read_delay_ns(self.block_size))
        if out is not None:
            out[:] = view
            return out
        return view.copy()

    # Raw 8-byte atomic-ish cell access used for BTT map & flog sequence words.
    # A single np.uint64 store is atomic w.r.t. Python threads (GIL) which
    # mirrors the 8-byte atomic store BTT relies on as its commit point.
    def store_u64(self, byte_off: int, value: int) -> None:
        if self.crash_hook is not None:
            self.crash_hook("pmem_u64_store")
        self._buf[byte_off:byte_off + 8] = np.frombuffer(
            np.uint64(value).tobytes(), dtype=np.uint8)

    def load_u64(self, byte_off: int) -> int:
        return int(np.frombuffer(self._buf[byte_off:byte_off + 8].tobytes(),
                                 dtype=np.uint64)[0])

    def persist(self) -> None:
        """msync for the file backend (fsync of the pool)."""
        if self._mm is not None:
            self._mm.flush()

    def close(self) -> None:
        if self._mm is not None:
            self._mm.flush()
            self._buf = None          # release the exported buffer first
            self._mm.close()
            os.close(self._fd)
            self._mm = None


class SimulatedCrash(Exception):
    """Raised by crash hooks to model power failure at a chosen point."""
