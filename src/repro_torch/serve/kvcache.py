"""Paged KV cache — BTT + Caiti re-expressed for the device/host tier pair.

The port of ``repro.serve.kvcache``; the mapping of the paper's
structures is the reference's:

  BTT map (lba -> pba)        -> per-sequence block table (logical page ->
                                 physical page in the device pool)
  BTT lanes / free blocks     -> the pool's free list
  DRAM transit cache          -> the device pool is the fast tier; the
                                 host tier (int8-packed) is the slow one
  eager eviction              -> a sequence that stops decoding has its
                                 pages packed (gather + int8 + Adler-32) to
                                 the host tier at once
  conditional bypass          -> a page allocation against a full pool goes
                                 straight to the host tier instead of
                                 evicting someone's hot page
  volume read tier            -> a CLOCK cache of dequantized host pages
                                 for the hybrid-attention slow path
  durable tier                -> an optional :class:`~repro_torch.serve
                                 .kvpager.KVPager` spills the host tier's
                                 overflow (past ``host_pages``) onto a
                                 striped volume as content-addressed atomic
                                 records, with decode-ahead prefetch, so
                                 session KV is bounded by the volume

The pools are one tensor per layer and K/V, (P, page_size, Hkv, hd), on
the cache's device: views ``k_pool[l] = kv[l, 0]`` and ``v_pool[l] =
kv[l, 1]`` of one (L, 2, P, page_size, Hkv, hd) allocation, which the
transit codec reads as a stack of 2L slots, so that a sequence's whole
page-out (every page, layer and K/V) is one launch, and so is its
page-in.  They are **updated in place** (a token write is an indexed
copy, a page-in is the restore kernel writing the pages), where the JAX
cache rebuilt immutable arrays with ``.at[].set``.  So the
reference's "eviction workers gather from an immutable snapshot" no longer
holds: every pool read and write happens under ``_tlock``.

A page-in keeps the reference loop's order where the volume is involved:
a spilled page's record is fetched (and promoted to the host tier) only
once every packed page before it in the table is restored and verified,
so ``activate`` restores the pending pages in one launch before each such
fetch and in one launch at the end.

Concurrency contract: ``seq.table``, ``self._free``, the host tier, the
active flags and the pools are guarded by ``_tlock`` — public entry points
take it, ``_locked`` helpers assume it.  With an eviction pool
(``evict_pool=``, the volume's ``SharedEvictionPool``), ``deactivate``
only queues one item per device page; the pool's workers run the
page-outs through ``_evict_slot`` / ``_evict_slots``, which take the same
lock for a whole batch, re-check each item under it (a sequence that is
active again, released, or whose page is no longer on the device is
skipped), gather every page of the batch in one codec launch, and return
the pool pages to the free list only after the copy to the host has been
synchronised.  ``activate`` drains the pool's work first.  A worker
launches on the cache's device and on the default stream, as the decode
thread does, so the two never overlap on the card.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.metrics import Metrics
from repro_torch.core.trace import trace_of
from repro_torch.kernels.ops import (gather_quantize_crc_units,
                                     paged_attention,
                                     scatter_dequantize_crc_units)
from repro_torch.volume.read_tier import ReadTier


@dataclass
class PagedCacheConfig:
    n_layers: int
    n_kv_heads: int
    head_dim: int
    page_size: int = 16
    n_pages: int = 256            # device pool pages (per layer)
    host_pages: int = 1024        # host-tier page budget (spill target
                                  # when a KVPager is attached)
    max_pages_per_seq: int = 64
    dtype: torch.dtype = torch.bfloat16
    eager_eviction: bool = True
    conditional_bypass: bool = True
    read_tier_pages: int = 128    # dequantized-page cache (0 disables)


class HostTier:
    """The slow tier: int8-packed pages + scales + the wire checksum the
    fused transit kernel computed at spill time, keyed (layer, handle)."""

    def __init__(self) -> None:
        self.pages: dict[tuple[int, int],
                         tuple[np.ndarray, np.ndarray, int]] = {}
        self._next = 0

    def put(self, layer: int, q: np.ndarray, scale: np.ndarray,
            crc: int = 0) -> int:
        h = self._next
        self._next += 1
        self.pages[(layer, h)] = (q, scale, crc)
        return h

    def get(self, layer: int, handle: int):
        return self.pages[(layer, handle)]

    def pop(self, layer: int, handle: int):
        return self.pages.pop((layer, handle))

    def __len__(self) -> int:
        return len(self.pages)


@dataclass
class Sequence:
    seq_id: int
    length: int = 0
    # logical page -> ("hbm", phys_page) | ("host", [(k_handle, v_handle)
    # per layer]) | ("host-fresh", {"k","v" raw f32}) | ("vol", pager handle)
    table: list = field(default_factory=list)
    active: bool = True


@dataclass
class StepPlan:
    """One decode step (``PagedKVCache.plan_step``): each sequence's pool
    pages and length once its new token is in, that token's row in a
    layer's pool seen as P * page_size rows (on the device), and the block
    table and lengths that the step's first ``plan_attention`` uploads."""
    pages: list[list[int]]
    lengths: list[int]
    slots: torch.Tensor
    table: torch.Tensor | None = None
    lens: torch.Tensor | None = None


def _host_f32(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class PagedKVCache:
    """Host-side manager + on-device pools for one model's KV state."""

    def __init__(self, cfg: PagedCacheConfig,
                 metrics: Metrics | None = None,
                 evict_pool=None, pager=None, device="cuda") -> None:
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.metrics = metrics or Metrics()
        self.trace = trace_of(self.metrics)
        # optional volume-backed spill tier: host pages past
        # ``cfg.host_pages`` descend to KVPager records
        self.pager = pager
        if pager is not None and getattr(pager, "own_metrics", False):
            pager.metrics = self.metrics     # unify the kv_* counters
            pager.own_metrics = False
        self._tlock = threading.Lock()
        # optional SharedEvictionPool: eager page-outs run on the volume's
        # eviction workers instead of the caller's thread
        self._evict_cv = threading.Condition(self._tlock)
        self._evict_pool = evict_pool
        self._inflight_evictions = 0
        L, P, pg, H, hd = (cfg.n_layers, cfg.n_pages, cfg.page_size,
                           cfg.n_kv_heads, cfg.head_dim)
        self._kv = torch.zeros((L, 2, P, pg, H, hd), dtype=cfg.dtype,
                               device=self.device)
        self.k_pool = [self._kv[li, 0] for li in range(L)]
        self.v_pool = [self._kv[li, 1] for li in range(L)]
        # each layer's K and V pools as (2, P * page, 1, Hkv, hd) token
        # rows, which a step's (2, B, 1, Hkv, hd) K/V go into by row
        self._token_rows = self._kv.view(L, 2, P * pg, 1, H, hd).unbind(0)
        self._free: list[int] = list(range(P))          # global free set
        self.host = HostTier()
        # clean read tier over the host tier: caches dequantized pages for
        # the hybrid-attention slow path
        self.read_tier = (ReadTier(block_size=None,
                                   n_slots=cfg.read_tier_pages,
                                   metrics=self.metrics)
                          if cfg.read_tier_pages > 0 else None)
        self.seqs: dict[int, Sequence] = {}
        self._next_seq = 0
        if evict_pool is not None:
            evict_pool.register(self)

    # ------------------------------------------------------------ allocation
    def free_pages(self) -> int:
        return len(self._free)

    def new_sequence(self) -> int:
        with self._tlock:
            sid = self._next_seq
            self._next_seq += 1
            self.seqs[sid] = Sequence(sid)
            return sid

    def _alloc_page(self) -> int | None:
        if self._free:
            return self._free.pop()
        return None

    def _evict_coldest_locked(self) -> bool:
        """Sync eviction (the staging fallback): pack the coldest inactive
        sequence's first device page to the host tier."""
        for seq in self.seqs.values():
            if seq.active:
                continue
            for li, entry in enumerate(seq.table):
                if entry[0] == "hbm":
                    self._page_out_locked([(seq, li)])
                    return True
        return False

    # -------------------------------------------------------------- write path
    def _reserve_slot_locked(self, seq: Sequence):
        """Give ``seq`` room for one more token: a fresh page when the last
        one is full (device pool, or host tier on bypass).  Returns the
        page's table entry and the token's offset in it."""
        pg = self.cfg.page_size
        off = seq.length % pg
        if off == 0:                                     # need a fresh page
            # max_pages_per_seq bounds the DENSE block table the fast
            # attention path builds — a longer sequence never gets a
            # device page (it would index past table_for's array)
            over = len(seq.table) >= self.cfg.max_pages_per_seq
            page = None if over else self._alloc_page()
            if page is None:
                if over and not self.cfg.conditional_bypass:
                    raise MemoryError(
                        f"seq {seq.seq_id} would grow to "
                        f"{len(seq.table) + 1} pages, past "
                        f"max_pages_per_seq={self.cfg.max_pages_per_seq}; "
                        f"raise the bound or enable conditional_bypass to "
                        f"let long sequences overflow to the host tier")
                if self.cfg.conditional_bypass:
                    # pool full (or table full) -> host tier
                    self.metrics.bump("bypass_pages")
                    if over:
                        self.metrics.bump("long_seq_bypass")
                    seq.table.append(("host-fresh", self._host_fresh_page()))
                    self._maybe_spill_locked()
                else:
                    with self.metrics.timer("cache_eviction_and_write"):
                        if not self._evict_coldest_locked():
                            raise MemoryError("KV pool exhausted")
                    self._maybe_spill_locked()
                    page = self._alloc_page()
                    seq.table.append(("hbm", page))
            else:
                seq.table.append(("hbm", page))
        entry = seq.table[seq.length // pg]
        seq.length += 1
        return entry, off

    def append_token(self, sid: int, k_token, v_token) -> None:
        """k/v_token: per-layer list of (Hkv, hd) tensors for ONE new token.
        A ``None`` layer reserves the slot without writing it (the decode
        loop fills layers > 0 with ``overwrite_token`` before they are
        read)."""
        with self._tlock:
            entry, off = self._reserve_slot_locked(self.seqs[sid])
            for li in range(self.cfg.n_layers):
                if k_token[li] is not None:
                    self._write_locked(entry, off, li, k_token[li],
                                       v_token[li])

    def append_tokens(self, sid: int, k_seq, v_seq) -> None:
        """The bulk write path of prefill: k/v_seq are per-layer lists of
        (T, Hkv, hd) tensors for T new tokens.  The pool ends up as T
        ``append_token`` calls would leave it, with one indexed copy per
        layer for the tokens that land in device pages.  A spill that a
        reservation triggers takes only inactive sequences' packed pages,
        never the slots being reserved."""
        T = k_seq[0].shape[0]
        with self._tlock:
            seq = self.seqs[sid]
            slots = [self._reserve_slot_locked(seq) for _ in range(T)]
            on_dev = [(t, e[1], off) for t, (e, off) in enumerate(slots)
                   if e[0] == "hbm"]
            if on_dev:
                tt, pages, offs = (torch.tensor(c, device=self.device)
                                   for c in zip(*on_dev))
                for li in range(self.cfg.n_layers):
                    self.k_pool[li][pages, offs] = k_seq[li].to(
                        self.device, self.cfg.dtype)[tt]
                    self.v_pool[li][pages, offs] = v_seq[li].to(
                        self.device, self.cfg.dtype)[tt]
            host = [(t, e, off) for t, (e, off) in enumerate(slots)
                    if e[0] != "hbm"]
            if host:
                ks = [_host_f32(k) for k in k_seq]
                vs = [_host_f32(v) for v in v_seq]
                for t, entry, off in host:
                    for li in range(self.cfg.n_layers):
                        entry[1]["k"][li][off] = ks[li][t]
                        entry[1]["v"][li][off] = vs[li][t]

    def _write_locked(self, entry, off: int, layer: int, k_t, v_t) -> None:
        if entry[0] == "hbm":
            page = entry[1]
            self.k_pool[layer][page, off] = k_t.to(self.device,
                                                   self.cfg.dtype)
            self.v_pool[layer][page, off] = v_t.to(self.device,
                                                   self.cfg.dtype)
        else:                                            # host-resident page
            entry[1]["k"][layer][off] = _host_f32(k_t)
            entry[1]["v"][layer][off] = _host_f32(v_t)

    def overwrite_token(self, sid: int, layer: int, kv) -> None:
        """Rewrite the LAST appended token's k/v for one layer (the decode
        loop appends at layer 0, then fills layers > 0 in place)."""
        with self._tlock:
            seq = self.seqs[sid]
            tpos = seq.length - 1
            entry = seq.table[tpos // self.cfg.page_size]
            self._write_locked(entry, tpos % self.cfg.page_size, layer, *kv)

    def _host_fresh_page(self) -> dict:
        L, pg, H, hd = (self.cfg.n_layers, self.cfg.page_size,
                        self.cfg.n_kv_heads, self.cfg.head_dim)
        return {"k": np.zeros((L, pg, H, hd), np.float32),
                "v": np.zeros((L, pg, H, hd), np.float32)}

    def _slots(self) -> torch.Tensor:
        """The pools as the codec's stack: (2L, P, page, Hkv * hd), slot
        ``2 * layer`` for K and ``2 * layer + 1`` for V."""
        return self._kv.view(2 * self.cfg.n_layers, self.cfg.n_pages,
                             self.cfg.page_size, -1)

    def _units(self, pages: list[int]) -> np.ndarray:
        """The codec's (n, 2) int32 (slot, page) list for these pages, in
        the reference's loop order: page, then layer, then K before V."""
        slots = 2 * self.cfg.n_layers
        units = np.empty((len(pages), slots, 2), np.int32)
        units[..., 0] = np.arange(slots, dtype=np.int32)
        units[..., 1] = np.asarray(pages, np.int32)[:, None]
        return units.reshape(-1, 2)

    def _to_host(self, *tensors) -> list[np.ndarray]:
        """Copy device tensors to the host with one synchronisation (pinned
        buffers, asynchronous copies); CPU tensors are returned as they
        are."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
               for t in tensors]
        for o, t in zip(out, tensors):
            o.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [o.numpy() for o in out]

    # ----------------------------------------------------------- transit ops
    def _page_out_locked(self, items: list[tuple[Sequence, int]]) -> None:
        """Transit these device pages ((sequence, logical page) pairs, of
        one sequence or several) to the host tier via the FUSED kernel:
        gather + int8 pack + wire checksum of every page, layer and K/V in
        one launch, one copy of each result to the host and one
        synchronisation.  Host entries and the free list change in item
        order, as the reference's page-by-page loop changes them; the
        pool pages go back to the free list only once every host entry
        has been read."""
        if not items:
            return
        L, span = self.cfg.n_layers, self.trace.span
        sids = {seq.seq_id for seq, _ in items}
        with span("kvcache.page_out", sids.pop() if len(sids) == 1 else None,
                  pages=len(items)):
            pages = [seq.table[lg][1] for seq, lg in items]
            with span("kvcache.page_out.gather"):
                units = torch.from_numpy(self._units(pages)).to(self.device)
                packed = gather_quantize_crc_units(self._slots(), units)
            with span("kvcache.page_out.to_host"):
                q, scales, crcs = self._to_host(*packed)
            with span("kvcache.page_out.entries", pages=len(items)):
                # one host entry per unit, in unit order, each owning its
                # bytes (a copy: an entry is freed on its own)
                entries = zip(map(np.ndarray.copy, q),
                              map(np.ndarray.copy, scales), crcs.tolist())
                for (seq, lg), page in zip(items, pages):
                    seq.table[lg] = ("host",
                                     [(self.host.put(li, *next(entries)),
                                       self.host.put(li, *next(entries)))
                                      for li in range(L)])
                    self._free.append(page)
            self.metrics.bump("pages_out", len(pages))
            # what the reference's loop counts: 2 passes and the K and V
            # payloads' bytes per layer per page
            self.metrics.bump("fused_kernel_passes", 2 * L * len(pages))
            self.metrics.bump("fused_kernel_bytes", q.nbytes)

    # ------------------------------------------------------ volume spill tier
    def host_page_count(self) -> int:
        """Logical pages currently in the host tier (packed or fresh)."""
        return sum(1 for seq in self.seqs.values()
                   for e in seq.table if e[0] in ("host", "host-fresh"))

    def _pack_page(self, handles) -> bytes:
        """Serialize one packed host page (all layers) for the pager:
        per layer, the fused-kernel crcs then the int8 payloads + f32
        scales — byte for byte the JAX cache's layout."""
        parts = []
        for li, (hk, hv) in enumerate(handles):
            qk, sk, ck = self.host.get(li, hk)
            qv, sv, cv = self.host.get(li, hv)
            parts.append(np.uint32(ck).tobytes())
            parts.append(np.uint32(cv).tobytes())
            parts.append(np.ascontiguousarray(qk, np.int8).tobytes())
            parts.append(np.ascontiguousarray(sk, "<f4").tobytes())
            parts.append(np.ascontiguousarray(qv, np.int8).tobytes())
            parts.append(np.ascontiguousarray(sv, "<f4").tobytes())
        return b"".join(parts)

    def _unpack_page(self, raw: bytes) -> list:
        """Inverse of :meth:`_pack_page` — per-layer
        ``(qk, sk, ck, qv, sv, cv)`` tuples (arrays not yet in the host
        tier; the caller decides whether to install them)."""
        pg = self.cfg.page_size
        D = self.cfg.n_kv_heads * self.cfg.head_dim
        qn, sn = pg * D, pg * 4
        out = []
        off = 0
        for _li in range(self.cfg.n_layers):
            ck = int(np.frombuffer(raw[off:off + 4], np.uint32)[0])
            cv = int(np.frombuffer(raw[off + 4:off + 8], np.uint32)[0])
            off += 8
            qk = np.frombuffer(raw[off:off + qn], np.int8).reshape(pg, D)
            off += qn
            sk = np.frombuffer(raw[off:off + sn], "<f4").astype(np.float32)
            off += sn
            qv = np.frombuffer(raw[off:off + qn], np.int8).reshape(pg, D)
            off += qn
            sv = np.frombuffer(raw[off:off + sn], "<f4").astype(np.float32)
            off += sn
            out.append((qk, sk, ck, qv, sv, cv))
        return out

    def _maybe_spill_locked(self) -> None:
        """Descend host-tier overflow onto the volume: while the host
        holds more than ``cfg.host_pages`` logical pages, spill the
        oldest INACTIVE sequence's packed pages as pager records
        (content-hash dedup makes prefix-shared pages one record).
        Host-fresh pages (raw f32, still being written) never spill."""
        if self.pager is None:
            return
        while self.host_page_count() > self.cfg.host_pages:
            victim = None
            for seq in self.seqs.values():               # oldest sid first
                if seq.active:
                    continue
                for li, entry in enumerate(seq.table):
                    if entry[0] == "host":
                        victim = (seq, li, entry[1])
                        break
                if victim is not None:
                    break
            if victim is None:                           # all hot: tolerate
                return
            seq, li, handles = victim
            handle = self.pager.spill(self._pack_page(handles))
            for lj, (hk, hv) in enumerate(handles):
                if self.read_tier is not None:
                    self.read_tier.invalidate(("page", lj, hk, hv))
                self.host.pop(lj, hk)
                self.host.pop(lj, hv)
            seq.table[li] = ("vol", handle)

    def prefetch(self, sid: int) -> int:
        """Decode-ahead restore for a suspended sequence: issue linked
        async reads for its volume records so ``activate()`` finds the
        payloads already in flight.  Returns chains issued."""
        if self.pager is None:
            return 0
        with self._tlock:
            seq = self.seqs.get(sid)
            if seq is None:
                return 0
            handles = [e[1] for e in seq.table if e[0] == "vol"]
        if not handles:
            return 0
        return self.pager.prefetch(handles)

    def _promote_locked(self, seq: Sequence, logical: int) -> None:
        """Bring a spilled page's record back into the host tier: fetch it
        (the pager verifies its wire crc and raises IOError before
        anything changes), install its layers as host entries, drop the
        record's reference."""
        handle = seq.table[logical][1]
        raw = self.pager.fetch(handle)                   # may raise IOError
        handles = [(self.host.put(li, qk, sk, ck), self.host.put(li, qv, sv, cv))
                   for li, (qk, sk, ck, qv, sv, cv)
                   in enumerate(self._unpack_page(raw))]
        self.pager.release(handle)
        seq.table[logical] = ("host", handles)

    def _restore_locked(self, seq: Sequence, got: list) -> np.ndarray:
        """Dequantize + scatter the packed host pages of ``got`` ((logical,
        pool page) pairs) into their pool pages in one launch, from one
        upload of their payloads, scales and unit list; returns the crcs
        of the payloads as received, (pages, L, 2)."""
        L, pg = self.cfg.n_layers, self.cfg.page_size
        with self.trace.span("kvcache.page_in.stage", pages=len(got)):
            entries = [self.host.get(li, h) for lg, _ in got
                       for li, pair in enumerate(seq.table[lg][1])
                       for h in pair]
            n, F = len(entries), entries[0][0].shape[-1]
            # one byte buffer: scales, units, then the int8 payloads at a
            # 16-byte boundary (the kernel's vector loads)
            s_end = n * pg * 4
            q_at = -(-(s_end + n * 8) // 16) * 16
            buf = torch.empty(q_at + n * pg * F, dtype=torch.uint8,
                              pin_memory=self.device.type == "cuda")
            host = buf.numpy()
            scales = host[:s_end].view(np.float32).reshape(n, pg)
            q = host[q_at:].view(np.int8).reshape(n, pg, F)
            for u, (qe, se, _) in enumerate(entries):
                q[u] = qe
                scales[u] = se
            host[s_end:s_end + n * 8].view(np.int32)[:] = self._units(
                [page for _, page in got]).reshape(-1)
        with self.trace.span("kvcache.page_in.scatter"):
            dev = buf.to(self.device, non_blocking=True)
            _, crcs = scatter_dequantize_crc_units(
                self._slots(), dev[s_end:s_end + n * 8].view(torch.int32)
                .view(n, 2), dev[q_at:].view(torch.int8).view(n, pg, F),
                dev[:s_end].view(torch.float32).view(n, pg))
            return crcs.cpu().numpy().reshape(len(got), L, 2)

    def _page_in_locked(self, seq: Sequence, got: list) -> None:
        """Bring the cold pages of ``got`` ((logical, allocated pool page)
        pairs, in table order) back into the pool.

        The fused restore kernel writes every packed page in place and
        checksums each int8 payload as received, all in one launch; then
        the pages are verified and committed in table order, layer by
        layer, K before V, as the reference's loop meets them.  At the
        first payload that does not match its spill-time crc, that page
        and every page allocated after it go back to the free list (in
        the order that leaves it as the reference's would be), their host
        entries stay put, and IOError is raised: an IOError never leaks
        capacity.  Raw f32 (host-fresh) pages are written as they commit."""
        with self.trace.span("kvcache.page_in", seq.seq_id,
                               pages=len(got)):
            codec = [(lg, page) for lg, page in got
                     if seq.table[lg][0] == "host"]
            crcs = self._restore_locked(seq, codec) if codec else None
            with self.trace.span("kvcache.page_in.verify"):
                self._commit_locked(seq, got, crcs)

    def _commit_locked(self, seq: Sequence, got: list, crcs) -> None:
        """``_page_in_locked``'s verify-and-commit loop, in table order;
        the counters are bumped once, with what the loop met before it
        returned or raised."""
        passes = nbytes = committed = j = 0
        try:
            for i, (lg, page) in enumerate(got):
                kind, payload = seq.table[lg]
                if kind == "host":
                    rc = crcs[j]
                    j += 1
                    for li, (hk, hv) in enumerate(payload):
                        qk, _, ck = self.host.get(li, hk)
                        qv, _, cv = self.host.get(li, hv)
                        passes += 2
                        nbytes += qk.nbytes + qv.nbytes
                        if int(rc[li, 0]) != ck or int(rc[li, 1]) != cv:
                            self.metrics.bump("transit_crc_errors")
                            for _, p in reversed(got[i:]):  # no capacity leak
                                self._free.append(p)
                            raise IOError(
                                f"KV transit checksum mismatch: layer {li} "
                                f"page {lg} of seq {seq.seq_id} tore in "
                                f"transit")
                    for li, (hk, hv) in enumerate(payload):  # verified
                        if self.read_tier is not None:
                            self.read_tier.invalidate(("page", li, hk, hv))
                        self.host.pop(li, hk)
                        self.host.pop(li, hv)
                else:                                    # host-fresh (raw f32)
                    for li in range(self.cfg.n_layers):
                        self.k_pool[li][page] = torch.tensor(
                            payload["k"][li],
                            device=self.device).to(self.cfg.dtype)
                        self.v_pool[li][page] = torch.tensor(
                            payload["v"][li],
                            device=self.device).to(self.cfg.dtype)
                seq.table[lg] = ("hbm", page)
                committed += 1
        finally:
            if committed:
                self.metrics.bump("pages_in", committed)
            if passes:
                self.metrics.bump("fused_kernel_passes", passes)
                self.metrics.bump("fused_kernel_bytes", nbytes)

    def deactivate(self, sid: int) -> int:
        """Sequence paused/finished: eagerly transit its pages out; returns
        how many device pages this call paged out itself: 0 with a pool,
        whose workers page them out later (and skip what ``release`` has
        dropped by then).

        With an eviction pool, one item per device page is submitted to
        the pool's workers (outside ``_tlock``) and the call returns; the
        workers page the items out in batches.  Without one, the page-out
        is one codec launch under ``_tlock`` — a concurrent deactivate of
        the same sequence sees "host" entries and skips, instead of
        double-freeing pool pages."""
        with self._tlock:
            seq = self.seqs[sid]
            seq.active = False
            if not self.cfg.eager_eviction:
                return 0
            items = [(seq, li) for li, entry in enumerate(seq.table)
                     if entry[0] == "hbm"]
            if self._evict_pool is None:
                self._page_out_locked(items)
                self._maybe_spill_locked()
                return len(items)
            self._inflight_evictions += len(items)
        for it in items:
            self._evict_pool.submit(self, it)
        return 0

    # eviction-pool participant hooks (the contract of the volume's caches)
    def _device(self):
        """The cache's card as the current device (a pool worker starts on
        device 0); nothing on the CPU."""
        return torch.cuda.device(self.device) if self.device.type == "cuda" \
            else contextlib.nullcontext()

    def _evict_slot(self, item) -> None:
        """One queued page-out, from a pool worker."""
        with self._device(), self._tlock:
            if self._evict_items_locked([item]):
                self._maybe_spill_locked()

    def _evict_slots(self, items) -> None:
        """A batch of queued page-outs, from a pool worker, possibly of
        several sequences: one lock acquisition and one codec launch."""
        self.metrics.bump("evict_batches")
        with self._device(), self._tlock:
            self._evict_items_locked(items)
            self._maybe_spill_locked()

    def _evict_items_locked(self, items) -> int:
        """Page out the items that still stand, in one launch; returns how
        many.  An item is skipped (``evict_skipped``) when its sequence is
        active again (a resume cancels its pending page-outs), has been
        released (its pool pages are already free, perhaps given to
        another sequence), or no longer has the page on the device."""
        live, seen = [], set()
        for seq, li in items:
            if (seq.active or self.seqs.get(seq.seq_id) is not seq
                    or seq.table[li][0] != "hbm" or (seq.seq_id, li) in seen):
                self.metrics.bump("evict_skipped")
                continue
            seen.add((seq.seq_id, li))
            live.append((seq, li))
        self._page_out_locked(live)
        return len(live)

    def _complete_eviction(self) -> None:
        with self._evict_cv:
            self._inflight_evictions -= 1
            self._evict_cv.notify_all()

    def drain_evictions(self, timeout: float = 10.0,
                        raise_on_timeout: bool = True) -> bool:
        """Barrier: wait until every submitted page-out has run.  Returns
        True when the drain completed; on expiry raises TimeoutError (or
        returns False with ``raise_on_timeout=False``) — a silent timeout
        would let ``activate()`` read tables that workers still change."""
        with self._evict_cv:
            done = self._evict_cv.wait_for(
                lambda: self._inflight_evictions == 0, timeout=timeout)
            pending = self._inflight_evictions
        if not done and raise_on_timeout:
            raise TimeoutError(
                f"drain_evictions: {pending} page-outs still in flight "
                f"after {timeout}s")
        return done

    def activate(self, sid: int) -> None:
        """Resume a sequence: page everything back in, the packed pages in
        one codec launch.  A spilled page's record is fetched and promoted
        to the host tier only after the pages before it are restored and
        verified, so the pending pages go in one launch before each fetch
        (an IOError, from the fetch or a restore, leaves the pages before
        it resident).  It may stall when the pool is full: the pages that
        got a pool page come in, a promoted record stays in the host tier,
        and the rest pages in on a later call.  With an eviction pool it
        first drains the pool's work (TimeoutError if that expires)."""
        if self._evict_pool is not None:
            self.drain_evictions()
        with self._tlock:
            seq = self.seqs[sid]
            seq.active = True
            got = []
            for li, entry in enumerate(seq.table):
                if entry[0] not in ("host", "host-fresh", "vol"):
                    continue
                if entry[0] == "vol":
                    self._page_in_locked(seq, got)
                    got = []
                    self._promote_locked(seq, li)
                page = self._alloc_page()
                if page is None:
                    self._page_in_locked(seq, got)
                    self.metrics.bump("activate_stalls")  # partial: retry
                    return
                got.append((li, page))
            self._page_in_locked(seq, got)

    def release(self, sid: int) -> None:
        with self._tlock, self.trace.span("kvcache.release", sid):
            seq = self.seqs.pop(sid)
            for entry in seq.table:
                if entry[0] == "hbm":
                    self._free.append(entry[1])
                elif entry[0] == "host":
                    for li, (hk, hv) in enumerate(entry[1]):
                        if self.read_tier is not None:
                            self.read_tier.invalidate(("page", li, hk, hv))
                        self.host.pop(li, hk)
                        self.host.pop(li, hv)
                elif entry[0] == "vol":
                    if self.read_tier is not None:
                        for li in range(self.cfg.n_layers):
                            self.read_tier.invalidate(
                                ("vol-page", li, entry[1]))
                    self.pager.release(entry[1])

    # -------------------------------------------------------------- attention
    def _upload(self, host: np.ndarray) -> torch.Tensor:
        """``host`` on the cache's device, copied from a pinned buffer
        without a wait (the caching host allocator keeps the buffer until
        the copy has run); on the CPU, ``host`` itself."""
        t = torch.from_numpy(host)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _table_upload(self, pages: list[list[int]], lengths: list[int]):
        """The dense (B, max_pages) table of these page rows and the (B,)
        lengths, int32, filled in one buffer and uploaded in one copy."""
        B, mp = len(pages), self.cfg.max_pages_per_seq
        host = np.zeros((B * mp + B,), np.int32)
        table = host[:B * mp].reshape(B, mp)
        for bi, row in enumerate(pages):
            table[bi, :len(row)] = row
        host[B * mp:] = lengths
        dev = self._upload(host)
        return dev[:B * mp].view(B, mp), dev[B * mp:]

    def _table_for_locked(self, sids: list[int]):
        mp = self.cfg.max_pages_per_seq
        pages = []
        for sid in sids:
            seq = self.seqs[sid]
            if len(seq.table) > mp:
                raise ValueError(
                    f"seq {sid} holds {len(seq.table)} pages > "
                    f"max_pages_per_seq={mp}: too long for the dense "
                    f"block table (serve it through the hybrid "
                    f"attention path)")
            row = [page for kind, page in seq.table if kind == "hbm"]
            if len(row) != len(seq.table):
                li = next(li for li, e in enumerate(seq.table)
                          if e[0] != "hbm")
                raise AssertionError(f"page {li} of seq {sid} not resident")
            pages.append(row)
        return self._table_upload(pages,
                                  [self.seqs[sid].length for sid in sids])

    def table_for(self, sids: list[int]):
        """Dense (B, max_pages) physical table + (B,) lengths, int32 on the
        cache's device.  Sequences must be fully resident (activate())."""
        with self._tlock:
            return self._table_for_locked(sids)

    def _page_kv(self, layer: int, entry) -> tuple[np.ndarray, np.ndarray]:
        """One logical page's (page_size, Hkv, hd) f32 k/v from whichever
        tier holds it (the transit read path: cache hit OR backend read)."""
        pg, H, hd = self.cfg.page_size, self.cfg.n_kv_heads, self.cfg.head_dim

        def dequant(q, scale):
            return (q.astype(np.float32) * scale[:, None]).reshape(pg, H, hd)
        if entry[0] == "hbm":
            return (_host_f32(self.k_pool[layer][entry[1]]),
                    _host_f32(self.v_pool[layer][entry[1]]))
        if entry[0] == "host":
            hk, hv = entry[1][layer]
            if self.read_tier is not None:
                cached = self.read_tier.lookup(("page", layer, hk, hv))
                if cached is not None:
                    return cached
            qk, sk, _ck = self.host.get(layer, hk)
            qv, sv, _cv = self.host.get(layer, hv)
            k, v = dequant(qk, sk), dequant(qv, sv)
            if self.read_tier is not None:
                self.read_tier.insert(("page", layer, hk, hv), (k, v))
            return k, v
        if entry[0] == "vol":
            # hybrid attention over a spilled page: restore the record
            # WITHOUT promoting it (the sequence stays cold); the read
            # tier amortizes the volume round trip across layers/steps
            handle = entry[1]
            if self.read_tier is not None:
                cached = self.read_tier.lookup(("vol-page", layer, handle))
                if cached is not None:
                    return cached
            out = None
            for li, (qk, sk, _ck, qv, sv, _cv) in enumerate(
                    self._unpack_page(self.pager.fetch(handle))):
                k, v = dequant(qk, sk), dequant(qv, sv)
                if self.read_tier is not None:
                    self.read_tier.insert(("vol-page", li, handle), (k, v))
                if li == layer:
                    out = (k, v)
            return out
        return (entry[1]["k"][layer].astype(np.float32),
                entry[1]["v"][layer].astype(np.float32))   # host-fresh

    def _paged_locked(self, layer: int, q, table, lens):
        """The block-table kernel over one layer's pools."""
        kp, vp = self.k_pool[layer], self.v_pool[layer]
        if q.dtype == kp.dtype:
            return paged_attention(q, kp, vp, table, lens)
        # a model whose dtype is not the pools' (an f32 model over the
        # default bf16 pools): f32 arithmetic over the widened pools, as
        # the reference's attention does
        return paged_attention(q.float(), kp.float(), vp.float(), table,
                               lens).to(q.dtype)

    def attention(self, layer: int, q, sids: list[int]):
        """q: (B, H, hd) one decode step for the given sequences.

        Fast path: every page device-resident AND every table within the
        dense bound -> the block-table kernel over the pools (lba->pba
        walk fused in).  Slow path (pages bypassed to the host tier under
        pool pressure, or a sequence past max_pages_per_seq): materialize
        each sequence's KV from every tier in f32, as the reference does,
        and run the same kernel over that view laid out as a pool of
        ``page_size`` pages with table row b = ``b * n_pg + arange(n_pg)``
        — decode keeps running instead of stalling on page-in."""
        mp = self.cfg.max_pages_per_seq
        pg, H, hd = self.cfg.page_size, self.cfg.n_kv_heads, self.cfg.head_dim
        B = len(sids)
        with self._tlock:
            # the pages the table walks, counted only while tracing
            walked = (sum(len(self.seqs[sid].table) for sid in sids)
                      if self.trace.tracing else 0)
            with self.trace.span("kvcache.table", pages=walked):
                resident = all(len(self.seqs[sid].table) <= mp
                               and all(e[0] == "hbm"
                                       for e in self.seqs[sid].table)
                               for sid in sids)
                if resident:
                    table, lens = self._table_for_locked(sids)
            if resident:
                return self._paged_locked(layer, q, table, lens)
            self.metrics.bump("hybrid_attention")
            n_pg = max(len(self.seqs[s].table) for s in sids)
            k = np.zeros((B, n_pg, pg, H, hd), np.float32)
            v = np.zeros((B, n_pg, pg, H, hd), np.float32)
            lens = np.zeros((B,), np.int32)
            for bi, sid in enumerate(sids):
                seq = self.seqs[sid]
                lens[bi] = seq.length
                for li, entry in enumerate(seq.table):
                    k[bi, li], v[bi, li] = self._page_kv(layer, entry)
        dev = q.device
        table = torch.arange(B * n_pg, dtype=torch.int32,
                             device=dev).reshape(B, n_pg)
        kview = torch.from_numpy(k.reshape(B * n_pg, pg, H, hd)).to(dev)
        vview = torch.from_numpy(v.reshape(B * n_pg, pg, H, hd)).to(dev)
        return paged_attention(q.float(), kview, vview, table,
                               torch.from_numpy(lens).to(dev)).to(q.dtype)

    # ------------------------------------------------------ decode-step plan
    def plan_step(self, sids: list[int]) -> StepPlan | None:
        """Reserve one slot for each sequence of a decode step, in ``sids``
        order and under one lock, so that the pages come off the free list
        as B ``append_token`` calls would take them; the slots go to the
        device in one upload.  Returns None, and reserves nothing, where a
        sequence is not wholly on the device, or its next page would not
        be (a bypass, an eviction, a table past ``max_pages_per_seq``):
        that step takes the per-token path.  Bumps ``decode_plan_steps``
        or ``decode_token_path_steps``.  The plan holds for every layer of
        the step: an eviction pool's workers page out only inactive
        sequences, and nothing else changes a running sequence's table
        between its layers."""
        pg, mp = self.cfg.page_size, self.cfg.max_pages_per_seq
        with self._tlock:
            seqs = [self.seqs[sid] for sid in sids]
            pages = [[page for kind, page in seq.table if kind == "hbm"]
                     for seq in seqs]
            fresh = [seq.length % pg == 0 for seq in seqs]
            if sum(fresh) > len(self._free) or any(
                    len(row) != len(seq.table) or len(row) + new > mp
                    for seq, row, new in zip(seqs, pages, fresh)):
                self.metrics.bump("decode_token_path_steps")
                return None
            slots = np.empty((len(seqs),), np.int64)
            for bi, (seq, row) in enumerate(zip(seqs, pages)):
                (_, page), off = self._reserve_slot_locked(seq)
                if off == 0:
                    row.append(page)
                slots[bi] = page * pg + off
            self.metrics.bump("decode_plan_steps")
            return StepPlan(pages, [seq.length for seq in seqs],
                            self._upload(slots))

    def write_step(self, plan: StepPlan, layer: int, k, v) -> None:
        """One layer's K and V of a planned step, (B, 1, Hkv, hd) each as
        the model projects them, into the step's slots: one indexed copy
        of both, cast to the pools' dtype, under one lock."""
        kv = torch.stack((k, v))
        if kv.dtype != self.cfg.dtype:
            kv = kv.to(self.cfg.dtype)
        with self._tlock:
            self._token_rows[layer].index_copy_(1, plan.slots, kv)

    def plan_attention(self, plan: StepPlan, layer: int, q):
        """``attention`` for a planned step, whose sequences are all on the
        device: the step's first call uploads the block table and lengths
        once, and every later layer reads them."""
        with self._tlock:
            if plan.table is None:
                with self.trace.span("kvcache.table",
                                     pages=sum(map(len, plan.pages))):
                    plan.table, plan.lens = self._table_upload(
                        plan.pages, plan.lengths)
            return self._paged_locked(layer, q, plan.table, plan.lens)

    # ---------------------------------------------------------------- stats
    def occupancy(self) -> float:
        return 1.0 - len(self._free) / self.cfg.n_pages
