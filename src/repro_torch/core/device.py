"""Block-device front end: composes a caching policy with a BTT backend and
exposes the bio interface the storage stack (benchmarks, ckpt engine) uses.

Device variants (paper §5 Setup):
  btt       — BTT alone (CoW+Flog atomicity, no cache)
  raw       — raw PMem, in-place writes, NO atomicity        (paper "PMem")
  dax       — raw PMem minus the block-layer bookkeeping     (paper "DAX")
  caiti     — BTT + Caiti transit cache                       (the paper)
  caiti-noee / caiti-nobp — ablations ('w/o EE', 'w/o BP')
  pmbd / pmbd70 / lru / coactive — staging baselines
"""
from __future__ import annotations

import os
import time

import numpy as np

from .bio import Bio, BioFlags, BioOp, SUCCESS
from .btt import BTT
from .cache import CaitiCache, CaitiConfig
from .metrics import Metrics
from .pmem import PMemSpace, LatencyModel, NO_LATENCY
from .policies import CoActiveCache, LRUCache, PMBD70Cache, PMBDCache

POLICIES = ("btt", "raw", "dax", "caiti", "caiti-noee", "caiti-nobp",
            "pmbd", "pmbd70", "lru", "coactive")


class _RawPMemDev:
    """In-place writes to PMem — fast, but a torn write is visible (no CoW)."""

    def __init__(self, pmem: PMemSpace, n_lbas: int, dax: bool = False,
                 metrics: Metrics | None = None) -> None:
        self.pmem = pmem
        self.n_lbas = n_lbas
        self.metrics = metrics or Metrics()
        # the block layer's per-bio software overhead that DAX avoids;
        # calibrated from the paper's BTT-vs-DAX gap discussion (§3)
        self._soft_ns = 0 if dax else 400

    def write(self, lba: int, data) -> int:
        t0 = time.perf_counter_ns()
        if self._soft_ns:
            end = t0 + self._soft_ns
            while time.perf_counter_ns() < end:
                pass
        self.pmem.write_block(lba, np.frombuffer(data, dtype=np.uint8))
        self.metrics.record_latency(time.perf_counter_ns() - t0)
        return SUCCESS

    def read(self, lba: int, out=None) -> np.ndarray:
        return self.pmem.read_block(lba, out=out)

    def flush(self, fua: bool = False) -> int:
        self.pmem.persist()
        return SUCCESS

    def fsync(self) -> int:
        return self.flush(fua=True)

    def occupancy(self) -> float:
        return 0.0

    def close(self) -> None:
        pass


class _BTTDev:
    """BTT without any cache (the paper's 'BTT' baseline)."""

    def __init__(self, btt: BTT, metrics: Metrics | None = None) -> None:
        self.btt = btt
        self.metrics = metrics or Metrics()

    def write(self, lba: int, data) -> int:
        t0 = time.perf_counter_ns()
        self.btt.write(lba, data)
        self.metrics.record_latency(time.perf_counter_ns() - t0)
        return SUCCESS

    def read(self, lba: int, out=None) -> np.ndarray:
        return self.btt.read(lba, out=out)

    def flush(self, fua: bool = False) -> int:
        self.btt.flush()
        return SUCCESS

    def fsync(self) -> int:
        return self.flush(fua=True)

    def occupancy(self) -> float:
        return 0.0

    def close(self) -> None:
        pass


class BlockDevice:
    """bio-speaking device: policy cache (or none) over BTT over PMem."""

    def __init__(self, impl, metrics: Metrics) -> None:
        self.impl = impl
        self.metrics = metrics

    # -- bio interface -------------------------------------------------------
    def submit_bio(self, bio: Bio) -> int:
        if bio.flags & BioFlags.REQ_PREFLUSH:
            self.impl.flush(fua=bool(bio.flags & BioFlags.REQ_FUA))
        if bio.op is BioOp.WRITE:
            ret = self.impl.write(bio.lba, bio.data)
        elif bio.op is BioOp.READ:
            self.impl.read(bio.lba)
            ret = SUCCESS
        else:
            ret = SUCCESS
        if bio.flags & BioFlags.REQ_FUA and bio.op is BioOp.WRITE:
            self.impl.flush(fua=True)
        bio.complete(ret)
        return ret

    # -- direct convenience API ----------------------------------------------
    def write(self, lba: int, data) -> int:
        return self.impl.write(lba, data)

    def read(self, lba: int, out=None) -> np.ndarray:
        return self.impl.read(lba, out=out)

    def flush(self) -> int:
        return self.impl.flush(fua=False)

    def fsync(self) -> int:
        return self.impl.fsync()

    def occupancy(self) -> float:
        return self.impl.occupancy()

    def close(self) -> None:
        self.impl.close()


def make_device(policy: str, *, n_lbas: int, block_size: int = 4096,
                cache_bytes: int = 512 << 20, backend: str = "ram",
                path: str | None = None,
                latency: LatencyModel | None = None,
                n_workers: int = 4, nfree: int | None = None,
                record_latencies: bool = False,
                evict_pool=None, read_tier=None, read_tier_bytes: int = 0,
                tier_ns: int = 0) -> BlockDevice:
    """Build a complete device stack for the given policy name.

    A file-backed pool that already carries a BTT info block is RECOVERED
    (Flog replay), not re-formatted — reopening after a crash must land on
    the last committed state.

    ``evict_pool`` (caiti policies only) hands background eviction to a
    shared cross-device pool (see ``repro_torch.volume.SharedEvictionPool``)
    instead of private worker threads.  ``read_tier`` attaches an existing
    clean DRAM read tier (``repro_torch.volume.ReadTier``, shared across volume
    shards via ``tier_ns``); ``read_tier_bytes > 0`` builds a private one
    for this device instead.  Caiti policies only — the staging baselines
    keep the paper's read path untouched.
    """
    assert policy in POLICIES, f"unknown policy {policy!r}"
    latency = NO_LATENCY if latency is None else latency
    metrics = Metrics()
    metrics.record_latencies = record_latencies
    # BTT needs headroom for metadata + free blocks
    meta_blocks = 2 + (n_lbas * 8) // block_size + 64
    existing = backend == "file" and path is not None and \
        os.path.exists(path) and os.path.getsize(path) > 0
    pmem = PMemSpace(n_lbas + 256 + meta_blocks, block_size=block_size,
                     backend=backend, path=path, latency=latency)
    if policy in ("raw", "dax"):
        impl = _RawPMemDev(pmem, n_lbas, dax=(policy == "dax"), metrics=metrics)
        return BlockDevice(impl, metrics)
    from .btt import _INFO_MAGIC
    fresh = not (existing and pmem.load_u64(0) == _INFO_MAGIC)
    btt = BTT(pmem, n_lbas=n_lbas, nfree=nfree, fresh=fresh)
    if policy == "btt":
        impl = _BTTDev(btt, metrics=metrics)
    elif policy.startswith("caiti"):
        cfg = CaitiConfig(capacity_bytes=cache_bytes, block_size=block_size,
                          n_workers=n_workers,
                          eager_eviction=(policy != "caiti-noee"),
                          conditional_bypass=(policy != "caiti-nobp"))
        if read_tier is None and read_tier_bytes > 0:
            from repro_torch.volume.read_tier import ReadTier
            read_tier = ReadTier(read_tier_bytes, block_size)
        impl = CaitiCache(btt, cfg, metrics=metrics, evict_pool=evict_pool,
                          read_tier=read_tier, tier_ns=tier_ns)
    elif policy == "pmbd":
        impl = PMBDCache(btt, cache_bytes, metrics=metrics)
    elif policy == "pmbd70":
        impl = PMBD70Cache(btt, cache_bytes, metrics=metrics)
    elif policy == "lru":
        impl = LRUCache(btt, cache_bytes, metrics=metrics)
    elif policy == "coactive":
        impl = CoActiveCache(btt, cache_bytes, metrics=metrics)
    else:  # pragma: no cover
        raise ValueError(policy)
    return BlockDevice(impl, metrics)
