"""Block object store on top of the PMem block device (the paper's stack,
used as the checkpoint substrate).

Layout (in lbas):
    [0]            root pointer block — THE atomic commit point: holds
                   (magic, generation, manifest_lba, manifest_len, checksum)
    [1 .. M]       manifest area (two ping-pong regions, written CoW-style)
    [M+1 .. end]   data blocks, bump-allocated per generation

A checkpoint *commit* depends on the device's atomicity primitive:

  * **single device** (block-level atomicity only): write the manifest
    blocks for the next generation into the inactive ping-pong region,
    fsync, then write the root block last and fsync again.  The BTT makes
    the root flip all-or-nothing, so a crash anywhere leaves the previous
    generation intact — at the price of double-written manifests and an
    extra fsync round trip;
  * **striped volume** (``supports_chained_tx``): root + manifest are one
    ``write_multi`` starting at lba 0 — the volume's chained-tx journal
    commits the whole object atomically (tail header = commit point), so
    the ping-pong double write and the separate root-flip pass are gone:
    one logical write, one fsync, same crash guarantee.
"""
from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from repro_torch.core import BlockDevice, make_device
from repro_torch.core.pmem import LatencyModel

_MAGIC = 0xCA171B10
_ROOT_FMT = "<QQQQQ"          # magic, generation, manifest_lba, manifest_len(bytes), crc


class BlockStore:
    """Keyed object store with generation-atomic commits."""

    def __init__(self, device, n_lbas: int,
                 manifest_blocks: int = 256, aio: bool = False) -> None:
        # ``device`` is anything speaking write/read/fsync/close — a single
        # BlockDevice or a repro_torch.volume.StripedVolume (sharded checkpoints)
        self.dev = device
        self.block_size = getattr(device, "block_size", None) or \
            (device.impl.btt.block_size
             if hasattr(getattr(device, "impl", None), "btt") else 4096)
        self.n_lbas = n_lbas
        self._manifest_cap = manifest_blocks
        self._data_base = 1 + 2 * manifest_blocks
        # chained-tx commit (striped volumes): root + manifest land as ONE
        # whole-object-atomic write_multi — no ping-pong, no root flip
        self._chained = bool(getattr(device, "supports_chained_tx", False)
                             and hasattr(device, "write_multi"))
        # overlapped I/O (striped volumes with the async frontend):
        # ``put`` submits its block writes and returns while they are in
        # flight; ``get`` fans its block reads out over the engine
        # workers.  Outstanding put tickets are settled (checked for
        # per-ticket errors) before any dependent read or commit.
        self._aio = bool(aio and hasattr(device, "submit"))
        # registered buffer pool (zero-copy puts): chunks serialize
        # straight into pre-pinned engine buffers — the engine takes the
        # handle without a defensive staging snapshot and releases the
        # slot from the completion path
        self._registry = (device.register_buffers(64)
                          if self._aio and hasattr(device,
                                                   "register_buffers")
                          else None)
        self._pending: list = []
        self._unsettled_keys: set[str] = set()
        self.generation = 0
        self._alloc_ptr = self._data_base
        # the manifest region the committed root points at — a fallback
        # (ping-pong) commit must never overwrite it before the flip
        self._active_mlba = 0
        # key -> (lba_start, n_blocks, nbytes) for the *current* generation
        self.directory: dict[str, tuple[int, int, int]] = {}
        self._load_root()

    # ------------------------------------------------------------- root I/O
    def _load_root(self) -> None:
        raw = bytes(self.dev.read(0)[: struct.calcsize(_ROOT_FMT)])
        magic, gen, mlba, mlen, crc = struct.unpack(_ROOT_FMT, raw)
        if magic != _MAGIC:
            return                                    # fresh store
        blocks = (mlen + self.block_size - 1) // self.block_size
        buf = b"".join(bytes(self.dev.read(mlba + i)) for i in range(blocks))
        payload = buf[:mlen]
        if zlib.crc32(payload) != crc:                # torn manifest: stale root
            return
        man = json.loads(payload.decode())
        self.generation = gen
        self._active_mlba = mlba
        self.directory = {k: tuple(v) for k, v in man["objects"].items()}
        self._alloc_ptr = man["alloc_ptr"]

    def _manifest_region(self, gen: int) -> int:
        """Ping-pong: even generations in region 0, odd in region 1."""
        return 1 + (gen % 2) * self._manifest_cap

    # ----------------------------------------------------------------- data
    def _alloc(self, n_blocks: int) -> int:
        lba = self._alloc_ptr
        if lba + n_blocks > self.n_lbas:
            # simple generational GC: restart the bump region (old data is
            # unreachable once a new root commits)
            lba = self._data_base
            self._alloc_ptr = lba
        self._alloc_ptr = lba + n_blocks
        assert self._alloc_ptr <= self.n_lbas, "store exhausted"
        return lba

    def _settle_pending(self) -> None:
        """Wait out EVERY in-flight put ticket (consuming their
        completions — a failure must not abandon siblings on the shared
        ring), then surface the first per-ticket device error here (on
        the dependent read/commit/close), not mid-flight."""
        pending, self._pending = self._pending, []
        keys, self._unsettled_keys = self._unsettled_keys, set()
        first_err = None
        for t in pending:
            self.dev.wait(t)
            if t.error is not None and first_err is None:
                first_err = t.error
        if first_err is not None:
            # the sync path never registers a key whose write failed; a
            # key whose blocks may be torn must not stay readable —
            # drop the whole unsettled batch (callers re-put on error)
            for k in keys:
                self.directory.pop(k, None)
            raise first_err


    def put(self, key: str, payload: bytes | memoryview) -> None:
        """Stage one object (writes go through the device's cache policy).

        With ``aio`` the block writes are SUBMITTED, not performed: the
        caller overlaps serialization of the next object with this one's
        descent through the stack; ``commit``/``get`` settle the
        tickets."""
        nbytes = len(payload)
        bs = self.block_size
        n_blocks = max(1, (nbytes + bs - 1) // bs)
        lba = self._alloc(n_blocks)
        mv = memoryview(payload)
        # plain per-block writes even on a striped volume: torn puts are
        # already invisible until commit() flips the root, so the volume's
        # redo journal would only double the write volume here
        for i in range(n_blocks):
            part = mv[i * bs:(i + 1) * bs]
            if self._aio and self._registry is not None:
                # zero-copy put: serialize the chunk straight into a
                # registered buffer — the one unavoidable copy (payload
                # -> wire) lands in the pinned slot, and the engine takes
                # the handle without a second staging snapshot
                buf = self._registry.acquire()
                arr = buf.data
                n = len(part)
                arr[:n] = np.frombuffer(part, dtype=np.uint8)
                if n < bs:
                    arr[n:] = 0
                # block=True: the engine's in-flight window is the flow
                # control — a put burst waits its turn, never fails
                self._pending.append(self.dev.submit("write", lba + i,
                                                     data=buf,
                                                     block=True))
                continue
            chunk = bytes(part)
            if len(chunk) < bs:
                chunk = chunk + b"\x00" * (bs - len(chunk))
            if self._aio:
                self._pending.append(self.dev.submit("write", lba + i,
                                                     data=chunk,
                                                     block=True))
            else:
                self.dev.write(lba + i, chunk)
        if self._aio:
            self._unsettled_keys.add(key)
        self.directory[key] = (lba, n_blocks, nbytes)

    def get(self, key: str) -> bytes:
        lba, n_blocks, nbytes = self.directory[key]
        out = np.empty(n_blocks * self.block_size, dtype=np.uint8)
        if self._aio:
            # overlapped ZERO-COPY restore: fan the block reads out
            # across the engine workers (a sliding window honoring the
            # in-flight bound), each landing directly in its slice of
            # the destination array (``out=`` — no post-poll copy out
            # of the completion ring), then settle in order
            self._settle_pending()   # reads must see completed puts
            bs = self.block_size
            tickets: dict[int, object] = {}
            next_sub = 0

            def pump(need: int = -1) -> None:
                nonlocal next_sub
                while next_sub < n_blocks:
                    dst = out[next_sub * bs:(next_sub + 1) * bs]
                    if next_sub <= need:
                        t = self.dev.submit("read", lba + next_sub,
                                            out=dst, block=True)
                    else:
                        # probe, don't count refusals as failures
                        t = self.dev.try_submit("read", lba + next_sub,
                                                out=dst)
                        if t is None:
                            return       # window full: gather first
                    tickets[next_sub] = t
                    next_sub += 1

            pump()
            err = None
            for i in range(n_blocks):
                if i not in tickets:
                    if err is not None:
                        break            # never submitted past a failure
                    pump(need=i)         # blocks until read i submitted
                t = tickets[i]
                self.dev.wait(t)         # consume even failed siblings
                if t.error is not None:
                    err = err or t.error
                    continue
                if err is None:          # data already landed in out=
                    pump()
            if err is not None:
                raise err
            return bytes(out[:nbytes])
        for i in range(n_blocks):
            self.dev.read(lba + i, out=out[i * self.block_size:
                                           (i + 1) * self.block_size])
        return bytes(out[:nbytes])

    def delete(self, key: str) -> None:
        self.directory.pop(key, None)

    def keys(self):
        return list(self.directory)

    # --------------------------------------------------------------- commit
    def commit(self) -> int:
        """Atomically publish the current directory as a new generation."""
        gen = self.generation + 1
        man = json.dumps({"objects": {k: list(v)
                                      for k, v in self.directory.items()},
                          "alloc_ptr": self._alloc_ptr}).encode()
        crc = zlib.crc32(man)
        bs = self.block_size
        n_blocks = (len(man) + bs - 1) // bs
        assert n_blocks <= self._manifest_cap, "manifest too large"
        chained = self._chained and (1 + n_blocks) <= \
            self.dev.max_atomic_write_blocks()
        if chained:
            mlba = 1
        else:
            mlba = self._manifest_region(gen)
            if mlba == self._active_mlba:
                # a prior chained commit parked the root on this region
                # (parity broken): use the OTHER one — writing over the
                # active manifest before the flip would destroy the
                # previous generation on crash
                mlba = 1 + self._manifest_cap if mlba == 1 else 1
        root = struct.pack(_ROOT_FMT, _MAGIC, gen, mlba, len(man), crc)
        root = root + b"\x00" * (bs - len(root))
        chunks = [man[i * bs:(i + 1) * bs] for i in range(n_blocks)]
        chunks = [c + b"\x00" * (bs - len(c)) for c in chunks]
        # 1. settle in-flight async puts, then drain the transit cache +
        #    BTT (all data durable first)
        self._settle_pending()
        if self._aio and chained:
            # linked-SQE commit: the whole fsync -> publish -> fsync
            # protocol is ONE ticket chain, waited once on the tail —
            # the dependencies execute in-engine instead of costing a
            # poll round trip per hop, and a failed stage CANCELS the
            # stages behind it (a failed data barrier can never be
            # followed by the atomic publish)
            t1 = self.dev.submit("fsync", block=True)
            t2 = self.dev.submit("write_multi", 0, blocks=[root] + chunks,
                                 link_to=t1, block=True)
            t3 = self.dev.submit("fsync", link_to=t2, block=True)
            self.dev.wait(t3)
            for t in (t1, t2, t3):       # settle + surface the ROOT cause
                self.dev.wait(t)
                if t.error is not None:
                    raise t.error
            self.generation = gen
            self._active_mlba = mlba
            return gen
        if self._aio:
            # ping-pong commit over the async frontend: data barrier ->
            # parallel manifest writes (linked to the barrier, so a
            # failed barrier cancels them) -> one settle point -> linked
            # root-flip chain.  Two waits total; the settle before the
            # flip mirrors the sync path's abort-before-root guarantee
            # (a torn manifest must never be published).
            head = self.dev.submit("fsync", block=True)
            writes = [self.dev.submit("write", mlba + i, data=chunk,
                                      link_to=head, block=True)
                      for i, chunk in enumerate(chunks)]
            barrier = self.dev.submit("fsync", block=True)  # IO_DRAIN
            self.dev.wait(barrier)
            for t in (head, *writes, barrier):
                self.dev.wait(t)
                if t.error is not None:
                    raise t.error
            troot = self.dev.submit("write", 0, data=root, block=True)
            tfin = self.dev.submit("fsync", link_to=troot, block=True)
            self.dev.wait(tfin)
            for t in (troot, tfin):
                self.dev.wait(t)
                if t.error is not None:
                    raise t.error
            self.generation = gen
            self._active_mlba = mlba
            return gen
        self.dev.fsync()
        if chained:
            # 2. ONE whole-object-atomic logical write: root + manifest.
            #    The chained-tx journal's tail header is the commit point
            #    — no ping-pong double write, no separate root flip.
            self.dev.write_multi(0, [root] + chunks)
            self.dev.fsync()
            self.generation = gen
            self._active_mlba = mlba
            return gen
        # 2. manifest into the inactive ping-pong region
        for i, chunk in enumerate(chunks):
            self.dev.write(mlba + i, chunk)
        self.dev.fsync()
        # 3. THE flip: one atomic root-block write (BTT CoW makes it
        #    all-or-nothing), then the final durability barrier
        self.dev.write(0, root)
        self.dev.fsync()
        self.generation = gen
        self._active_mlba = mlba
        return gen

    def close(self) -> None:
        # surface any in-flight put failure instead of silently
        # swallowing the only error report (the sync path raises in put)
        self._settle_pending()
        self.dev.close()


def make_blockstore(path: str | None = None, *, policy: str = "caiti",
                    capacity_bytes: int = 1 << 30, block_size: int = 4096,
                    cache_bytes: int = 64 << 20,
                    latency: LatencyModel | None = None,
                    n_shards: int = 1,
                    read_tier_bytes: int = 0,
                    aio: bool = False,
                    cluster: int = 0,
                    replication_k: int = 2) -> BlockStore:
    """``n_shards > 1`` stripes the store over a multi-device volume:
    checkpoint blocks spread across all shards' PMem (aggregate bandwidth)
    and multi-block puts ride the volume journal.  ``read_tier_bytes > 0``
    fronts the device(s) with a clean DRAM read tier — the restore path
    (``get`` walking manifest + chunk blocks) re-reads hot metadata blocks
    through DRAM instead of PMem.  ``aio`` (volumes only) issues put/get
    block I/O through the volume's async frontend: writes overlap the
    caller's next serialization step, restore reads fan out across the
    engine workers.

    ``cluster = N > 0`` backs the store with an N-node distributed
    ``ClusterVolume`` instead (``replication_k`` copies per chunk):
    checkpoints survive whole-node loss — puts are chain-replicated and
    acked on K durable tails, restores fail over past dead or corrupt
    members via the cluster crc ledger.  The BlockStore itself is
    unchanged: the cluster speaks the same chained-tx write_multi /
    verified-read surface as the striped volume, and manifest commits
    stay whole-object atomic because the cluster caps
    ``max_atomic_write_blocks`` at one placement chunk."""
    n_lbas = capacity_bytes // block_size
    if cluster > 0:
        from repro_torch.cluster import make_cluster
        dev = make_cluster(policy, n_lbas=n_lbas, n_nodes=cluster,
                           replication_k=replication_k,
                           block_size=block_size, cache_bytes=cache_bytes,
                           node_shards=n_shards if n_shards > 1 else 2,
                           backend="file" if path else "ram", path=path,
                           read_tier_bytes=read_tier_bytes)
    elif n_shards > 1:
        from repro_torch.volume import make_volume
        dev = make_volume(policy, n_lbas=n_lbas, n_shards=n_shards,
                          block_size=block_size, cache_bytes=cache_bytes,
                          backend="file" if path else "ram", path=path,
                          latency=latency, read_tier_bytes=read_tier_bytes)
    else:
        dev = make_device(policy, n_lbas=n_lbas, block_size=block_size,
                          cache_bytes=cache_bytes,
                          backend="file" if path else "ram", path=path,
                          latency=latency, read_tier_bytes=read_tier_bytes)
    return BlockStore(dev, n_lbas, aio=aio)
