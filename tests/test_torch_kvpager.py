"""The port's volume-backed KV spill tier (``serve/kvpager.py`` and the
cache's pager path) on the CPU, at small sizes.

Every pager-path scenario of ``tests/test_kvpager.py``, each on a volume
from the port's own ``make_volume``.  Then the port's cache and the JAX
cache (its codec on the eager ``repro.kernels.ref`` oracles, since its
Pallas codec does not trace on this jax) each with its own pager and
volume, driven through the same spills, page-ins, stalls, torn records and
prefetches: every end state is held equal, and the port restores a
sequence's packed pages in at most one launch per fetched record plus
one.  Then the wire format in both directions, the CLI and the engine."""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.serve import kvcache as jkv
from repro.serve.kvcache import PagedCacheConfig as JaxCacheConfig
from repro.serve.kvcache import PagedKVCache as JaxKVCache
from repro.serve.kvpager import KVPager as JaxPager
from repro.volume.volume import make_volume as jax_make_volume
from repro_torch.configs import get_config
from repro_torch.core.metrics import KV_PAGING_COUNTERS, Metrics
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.transformer import init_lm
from repro_torch.serve import (KVPager, PagedCacheConfig, PagedKVCache,
                               ServeEngine)
from repro_torch.serve import kvcache as tkv
from repro_torch.volume.volume import make_volume

# small, but a page's record spans 3 blocks: chained writes, linked reads
SHAPE = dict(n_layers=2, n_kv_heads=4, head_dim=128, page_size=4)


@pytest.fixture
def volumes():
    """A factory of volumes (the port's by default), every one closed at
    the end of the test so no aio or eviction thread outlives it."""
    made = []

    def make(n_lbas=1024, factory=make_volume):
        vol = factory(n_lbas=n_lbas, n_shards=2, aio_workers=2,
                      cache_bytes=1 << 22)
        made.append(vol)
        return vol
    yield make
    for vol in made:
        vol.close()


def _cfg(**kw):
    base = dict(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4,
                n_pages=8, host_pages=64, max_pages_per_seq=8,
                read_tier_pages=8, dtype=torch.float32)
    base.update(kw)
    return PagedCacheConfig(**base)


def _cache(pager=None, metrics=None, **kw):
    return PagedKVCache(_cfg(**kw), metrics=metrics or Metrics(),
                        pager=pager, device="cpu")


def _fill(cache, sid, n_tokens, rng):
    L = cache.cfg.n_layers
    H, hd = cache.cfg.n_kv_heads, cache.cfg.head_dim
    for _ in range(n_tokens):
        k = torch.tensor(rng.normal(size=(H, hd)), dtype=torch.float32)
        v = torch.tensor(rng.normal(size=(H, hd)), dtype=torch.float32)
        cache.append_token(sid, [k] * L, [v] * L)


# ------------------------------------------------------------------ pager
def test_pager_roundtrip_dedup_and_slot_reuse(volumes):
    m = Metrics()
    pager = KVPager(volumes(), capacity_blocks=64, metrics=m)
    payload = bytes(range(256)) * 20               # 5120 B -> 2 blocks
    h1 = pager.spill(payload)
    h2 = pager.spill(payload)                      # content-hash dedup
    assert h1 == h2
    assert m.count["kv_dedup_hits"] == 1
    assert m.count["kv_spills"] == 1
    assert pager.fetch(h1) == payload
    other = pager.spill(b"different" * 600)
    assert other != h1
    free0 = pager.free_slots()
    pager.release(h1)
    assert pager.free_slots() == free0             # one ref still live
    pager.release(h1)
    assert pager.free_slots() == free0 + 1         # slot freed
    assert m.count["kv_spill_frees"] == 1
    h3 = pager.spill(payload)                      # slot reused, new handle
    assert h3 != h1
    assert pager.fetch(h3) == payload
    path = m.kv_paging_path()
    assert path["kv_restore_crc_errors"] == 0
    assert path["dedup_rate"] == pytest.approx(0.25)   # 3 spills, 1 dedup


def test_pager_wire_crc_detects_torn_record(volumes):
    m = Metrics()
    vol = volumes()
    pager = KVPager(vol, capacity_blocks=64, metrics=m)
    h = pager.spill(b"kvpage" * 900)               # 2 blocks
    rec = pager._records[h]
    for t in rec.spill_tickets:
        vol.wait(t)
    # tear the record's second block behind the pager's back
    vol.write(rec.lba + 1, np.frombuffer(b"\xff" * vol.block_size, np.uint8))
    with pytest.raises(IOError, match="wire checksum"):
        pager.fetch(h)
    assert m.count["kv_restore_crc_errors"] == 1
    assert m.count["kv_restores"] == 0


def test_pager_prefetch_hit_and_wasted_counters(volumes):
    m = Metrics()
    pager = KVPager(volumes(), capacity_blocks=64, metrics=m)
    h1 = pager.spill(b"a" * 5000)
    h2 = pager.spill(b"b" * 5000)
    assert pager.prefetch([h1, h2]) == 2
    assert pager.prefetch([h1]) == 0               # already in flight
    assert pager.fetch(h1) == b"a" * 5000
    pager.release(h2)                              # unconsumed prefetch
    assert m.count["kv_prefetch_issued"] == 2
    assert m.count["kv_prefetch_hits"] == 1
    assert m.count["kv_prefetch_wasted"] == 1


def test_pager_prefetch_backs_off_a_record_wider_than_the_window(volumes):
    """A record's reads go as one linked chain: a chain longer than the
    volume's in-flight window (``max_inflight``) is never issued, and the
    fetch reads it synchronously."""
    m = Metrics()
    pager = KVPager(volumes(), capacity_blocks=256, metrics=m)
    payload = b"w" * (17 * 4096)                   # 18 blocks > 16
    h = pager.spill(payload)
    assert pager.prefetch([h]) == 0
    assert pager.fetch(h) == payload
    assert m.count.get("kv_prefetch_issued", 0) == 0
    assert m.count["kv_restores"] == 1


def test_pager_capacity_exhaustion_is_loud(volumes):
    pager = KVPager(volumes(), capacity_blocks=2, metrics=Metrics())
    pager.spill(b"a" * 100)                        # 1 block -> 2 slots
    pager.spill(b"b" * 100)
    with pytest.raises(MemoryError, match="spill tier exhausted"):
        pager.spill(b"c" * 100)


def test_kv_paging_path_metrics_shape():
    m = Metrics()
    path = m.kv_paging_path()
    for key in KV_PAGING_COUNTERS:
        assert path[key] == 0
    assert path["dedup_rate"] == 0.0
    assert path["prefetch_hit_rate"] == 0.0
    m.bump("kv_spills", 3)
    m.bump("kv_dedup_hits", 1)
    m.bump("kv_restores", 2)
    m.bump("kv_prefetch_hits", 1)
    path = m.kv_paging_path()
    assert path["dedup_rate"] == pytest.approx(0.25)
    assert path["prefetch_hit_rate"] == pytest.approx(0.5)


# ------------------------------------------------- cache <-> volume tier
def test_spill_restore_preserves_kv_exactly(volumes):
    """The volume round trip carries the int8 payload bit-exactly:
    attention after a restore through the volume equals attention after a
    plain host-tier round trip of the same tokens."""
    toks = np.random.default_rng(3).normal(size=(12, 2, 2, 8)) \
        .astype(np.float32)

    def build(pager, host_pages):
        c = _cache(pager, host_pages=host_pages)
        sid = c.new_sequence()
        for t in range(12):
            c.append_token(sid, [torch.tensor(toks[t, 0])] * 2,
                           [torch.tensor(toks[t, 1])] * 2)
        c.deactivate(sid)
        c.activate(sid)
        q = torch.ones((1, 2, 8))
        return c, c.attention(0, q, [sid])

    _, ref = build(None, 64)                       # host-only round trip
    c2, got = build(KVPager(volumes(), capacity_blocks=256), 0)
    count = c2.metrics.count
    assert count["kv_spills"] == 3 and count["kv_restores"] == 3
    assert count["kv_restore_crc_errors"] == 0
    assert count.get("transit_crc_errors", 0) == 0
    assert torch.equal(got, ref)


def test_hybrid_attention_reads_spilled_pages_without_promotion(volumes):
    """A cold sequence's attention serves straight off the volume: no
    page-in, values equal to the host tier's dequantization, and the read
    tier keeps every layer of a fetched record."""
    toks = np.random.default_rng(4).normal(size=(8, 2, 2, 8)) \
        .astype(np.float32)

    def build(pager, host_pages):
        c = _cache(pager, host_pages=host_pages, n_pages=4)
        sid = c.new_sequence()
        for t in range(8):
            c.append_token(sid, [torch.tensor(toks[t, 0])] * 2,
                           [torch.tensor(toks[t, 1])] * 2)
        c.deactivate(sid)
        return c, sid

    c1, s1 = build(None, 64)
    c2, s2 = build(KVPager(volumes(), capacity_blocks=256), 0)
    assert [e[0] for e in c2.seqs[s2].table] == ["vol", "vol"]
    q = torch.ones((1, 2, 8))
    assert torch.equal(c2.attention(1, q, [s2]), c1.attention(1, q, [s1]))
    count = c2.metrics.count
    assert count["hybrid_attention"] == 1 and count["kv_restores"] == 2
    assert all(e[0] == "vol" for e in c2.seqs[s2].table)    # still cold
    assert count.get("pages_in", 0) == 0
    assert torch.equal(c2.attention(0, q, [s2]), c1.attention(0, q, [s1]))
    assert count["kv_restores"] == 2               # layer 0 from the tier


def test_prefetch_then_activate_hits(volumes):
    m = Metrics()
    pager = KVPager(volumes(), capacity_blocks=256, metrics=m)
    c = _cache(pager, m, host_pages=0, read_tier_pages=0)
    sid = c.new_sequence()
    _fill(c, sid, 8, np.random.default_rng(5))
    c.deactivate(sid)
    n_vol = sum(1 for e in c.seqs[sid].table if e[0] == "vol")
    assert n_vol == 2
    assert c.prefetch(sid) == n_vol
    c.activate(sid)
    path = m.kv_paging_path()
    assert path["kv_prefetch_hits"] == n_vol
    assert path["prefetch_hit_rate"] == 1.0
    assert all(e[0] == "hbm" for e in c.seqs[sid].table)
    c.release(sid)
    assert pager.stats()["records"] == 0


def test_page_in_crc_mismatch_returns_pool_page():
    """A corrupted host payload surfaces as IOError and a counter bump
    without leaking the pool page allocated for the restore, and without
    popping any host handle (the sequence stays consistently cold)."""
    c = _cache(read_tier_pages=0)
    sid = c.new_sequence()
    _fill(c, sid, 4, np.random.default_rng(0))
    c.deactivate(sid)
    assert c.seqs[sid].table[0][0] == "host"
    hk, _hv = c.seqs[sid].table[0][1][0]
    q, s, crc = c.host.get(0, hk)
    q = q.copy()
    q[0, 0] ^= 0x5A                                # tear one byte
    c.host.pages[(0, hk)] = (q, s, crc)
    free_before, host_before = c.free_pages(), len(c.host)
    with pytest.raises(IOError, match="tore in transit"):
        c.activate(sid)
    assert c.metrics.count["transit_crc_errors"] == 1
    assert c.free_pages() == free_before, "restore leaked a pool page"
    assert len(c.host) == host_before, "partial page-in popped handles"
    assert c.seqs[sid].table[0][0] == "host"


def test_release_accounts_mixed_hbm_host_fresh_vol_pages(volumes):
    m = Metrics()
    pager = KVPager(volumes(), capacity_blocks=256, metrics=m)
    c = _cache(pager, m, n_pages=4, host_pages=2)
    rng = np.random.default_rng(1)
    a = c.new_sequence()
    _fill(c, a, 8, rng)                            # 2 hbm pages
    b = c.new_sequence()
    _fill(c, b, 8, rng)                            # pool now full
    _fill(c, b, 4, rng)                            # bypass -> host-fresh
    c.deactivate(a)                                # a's pages -> host, vol
    assert [e[0] for e in c.seqs[a].table] == ["vol", "host"]
    assert c.free_pages() == 2                     # a's pool pages freed
    assert [e[0] for e in c.seqs[b].table] == ["hbm", "hbm", "host-fresh"]
    q = torch.ones((1, 2, 8))
    c.attention(0, q, [a])                         # "vol-page" + "page" keys
    assert len(c.read_tier) == 3
    c.release(b)                                   # hbm + host-fresh mix
    assert c.free_pages() == 4
    c.release(a)                                   # spilled + packed pages
    assert c.free_pages() == 4
    assert len(c.host) == 0 and len(c.read_tier) == 0
    assert pager.stats()["records"] == 0
    assert pager.free_slots() == pager.stats()["n_slots"]
    assert m.count["kv_spill_frees"] == 1
    assert c.seqs == {}


# ------------------------------------------- pager path vs reference loop
COUNTERS = (*KV_PAGING_COUNTERS, "pages_out", "pages_in", "activate_stalls",
            "transit_crc_errors", "fused_kernel_passes", "fused_kernel_bytes",
            "bypass_pages", "hybrid_attention", "read_tier_hits",
            "read_tier_fills")


def _oracle_gather(pool, ids):
    q, s = jref.gather_quantize_ref(pool, ids)
    return q, s, jref.transit_crc_ref(q)


def _oracle_scatter(pool, ids, q, s):
    return (jref.scatter_dequantize_ref(pool, ids, q, s),
            jref.transit_crc_ref(q))


class _Twins:
    """The port's cache on the port's pager and volume, and the JAX cache
    on the reference's, driven by the same calls."""

    def __init__(self, volumes, **kw):
        base = dict(SHAPE, n_pages=8, max_pages_per_seq=8, read_tier_pages=8,
                    host_pages=0)
        base.update(kw)
        self.tp = KVPager(volumes(), capacity_blocks=256)
        self.jp = JaxPager(volumes(factory=jax_make_volume),
                           capacity_blocks=256)
        self.t = PagedKVCache(PagedCacheConfig(**base, dtype=torch.float32),
                              metrics=Metrics(), pager=self.tp, device="cpu")
        self.j = JaxKVCache(JaxCacheConfig(**base, dtype=jnp.float32),
                            pager=self.jp)
        self.rng = np.random.default_rng(7)
        self.launches = []                     # the port's restore launches

    def new(self) -> int:
        sid = self.t.new_sequence()
        assert self.j.new_sequence() == sid
        return sid

    def fill(self, sid, n_tokens, bulk=False) -> None:
        """n_tokens on both: token by token, or the port's bulk prefill
        write against the reference's token loop."""
        L, H, hd = SHAPE["n_layers"], SHAPE["n_kv_heads"], SHAPE["head_dim"]
        kv = self.rng.standard_normal((n_tokens, 2, L, H, hd)) \
            .astype(np.float32)
        if bulk:
            self.t.append_tokens(sid, list(torch.tensor(kv[:, 0]
                                                        .swapaxes(0, 1))),
                                 list(torch.tensor(kv[:, 1].swapaxes(0, 1))))
        for t in range(n_tokens):
            if not bulk:
                self.t.append_token(sid, list(torch.tensor(kv[t, 0])),
                                    list(torch.tensor(kv[t, 1])))
            self.j.append_token(sid, list(jnp.asarray(kv[t, 0])),
                                list(jnp.asarray(kv[t, 1])))

    def both(self, method, sid, *args):
        """Call ``method`` on both; they raise the same error or none, and
        the port's ``activate`` launches the restore at most once per
        record it fetched plus once (exactly once with no record)."""
        errors, out = [], []
        for c in (self.t, self.j):
            n0 = len(self.launches)
            fetched0 = sum(c.metrics.count.get(k, 0) for k in
                           ("kv_restores", "kv_restore_crc_errors"))
            vol = any(e[0] == "vol" for e in c.seqs[sid].table)
            try:
                out.append(getattr(c, method)(sid, *args))
                errors.append(None)
            except IOError as e:
                errors.append(str(e))
            if c is self.t and method == "activate":
                n = len(self.launches) - n0
                fetched = sum(c.metrics.count.get(k, 0) for k in
                              ("kv_restores", "kv_restore_crc_errors")) \
                    - fetched0
                assert n <= fetched + 1 if vol else n <= 1, (n, fetched)
        assert errors[0] == errors[1]
        if method == "prefetch":
            assert out[0] == out[1]
        return errors[0]

    def attend(self, layer, sids) -> None:
        q = self.rng.standard_normal((len(sids), 4, SHAPE["head_dim"])) \
            .astype(np.float32)
        got = self.t.attention(layer, torch.tensor(q), sids)
        exp = self.j.attention(layer, jnp.asarray(q), sids, use_kernel=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=2e-5,
                                   rtol=2e-5)

    def tear_host(self, sid, logical, layer, kv) -> None:
        """Flip one payload byte of a host entry in both caches."""
        for c in (self.t, self.j):
            h = c.seqs[sid].table[logical][1][layer][kv]
            q, s, crc = c.host.get(layer, h)
            torn = np.array(q)
            torn[1, 3] ^= 0x20
            c.host.pages[(layer, h)] = (torn, s, crc)

    def tear_record(self, sid, logical) -> None:
        """Flip one byte of a spilled page's record on both volumes."""
        for c, p in ((self.t, self.tp), (self.j, self.jp)):
            rec = p._records[c.seqs[sid].table[logical][1]]
            for t in rec.spill_tickets:
                p.vol.wait(t)
            raw = p.vol.read(rec.lba + 1).copy()
            raw[100] ^= 0x01
            p.vol.write(rec.lba + 1, raw)

    def assert_same(self) -> None:
        t, j = self.t, self.j
        assert list(t._free) == list(j._free)
        assert ({k: t.metrics.count.get(k, 0) for k in COUNTERS}
                == {k: j.metrics.count.get(k, 0) for k in COUNTERS})
        assert t.host.pages.keys() == j.host.pages.keys()
        assert t.host._next == j.host._next
        for key, (q, s, crc) in t.host.pages.items():
            jq, js, jcrc = j.host.pages[key]
            assert np.array_equal(q, np.asarray(jq))
            assert np.array_equal(s, np.asarray(js))
            assert crc == int(jcrc)
        assert t.seqs.keys() == j.seqs.keys()
        for sid, seq in t.seqs.items():
            jseq = j.seqs[sid]
            assert (seq.length, seq.active) == (jseq.length, jseq.active)
            assert [e[0] for e in seq.table] == [e[0] for e in jseq.table]
            for et, ej in zip(seq.table, jseq.table):
                if et[0] == "hbm":
                    assert et[1] == ej[1]
                    for li in range(SHAPE["n_layers"]):
                        for tp, jp in ((t.k_pool, j.k_pool),
                                       (t.v_pool, j.v_pool)):
                            assert np.array_equal(tp[li][et[1]].numpy(),
                                                  np.asarray(jp[li][ej[1]]))
                elif et[0] in ("host", "vol"):
                    assert et[1] == ej[1]
                else:
                    for kv in ("k", "v"):
                        assert np.array_equal(et[1][kv], ej[1][kv])
        self._same_read_tier(t.read_tier, j.read_tier)
        self._same_pager()

    @staticmethod
    def _same_read_tier(a, b) -> None:
        assert (a._keys, a._map, bytes(a._ref), a._hand) == \
            (b._keys, b._map, bytes(b._ref), b._hand)
        assert (a.hits, a.misses, a.fills, a.invalidations) == \
            (b.hits, b.misses, b.fills, b.invalidations)
        for x, y in zip(a._objs, b._objs):
            assert (x is None) == (y is None)
            if x is not None:
                assert all(np.array_equal(u, np.asarray(w))
                           for u, w in zip(x, y))

    def _same_pager(self) -> None:
        a, b = self.tp, self.jp
        assert (a._slot_blocks, a._n_slots, a._free_slots, a._next_handle,
                a._by_key) == (b._slot_blocks, b._n_slots, b._free_slots,
                               b._next_handle, b._by_key)
        assert a._records.keys() == b._records.keys()
        for h, ra in a._records.items():
            rb = b._records[h]
            assert (ra.slot, ra.lba, ra.n_blocks, ra.key, ra.refs,
                    ra.pf_tickets is None) == \
                (rb.slot, rb.lba, rb.n_blocks, rb.key, rb.refs,
                 rb.pf_tickets is None)
            for t in ra.spill_tickets:
                a.vol.wait(t)
            for t in rb.spill_tickets:
                b.vol.wait(t)
            for i in range(ra.n_blocks):           # the record's bytes
                assert np.array_equal(a.vol.read(ra.lba + i),
                                      b.vol.read(rb.lba + i))


@pytest.fixture
def twins(monkeypatch, volumes):
    monkeypatch.setattr(jkv, "gather_quantize_crc", _oracle_gather)
    monkeypatch.setattr(jkv, "scatter_dequantize_crc", _oracle_scatter)
    made = []
    restore = tkv.scatter_dequantize_crc_units

    def counted(*args):
        for tw in made:
            tw.launches.append(1)
        return restore(*args)
    monkeypatch.setattr(tkv, "scatter_dequantize_crc_units", counted)

    def make(**kw):
        tw = _Twins(volumes, **kw)
        made.append(tw)
        return tw
    return make


def _kinds(tw, sid):
    kinds = [e[0] for e in tw.t.seqs[sid].table]
    assert kinds == [e[0] for e in tw.j.seqs[sid].table]
    return kinds


SCENARIOS = ["deactivate", "fully-spilled", "spilled-then-host",
             "host-then-spilled", "stall-after-promotion", "wire-crc",
             "transit-tear", "prefetched", "prefetch-wasted", "dedup",
             "bypass-prefill"]


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_pager_end_state_equals_the_reference_loop(twins, scenario):
    if scenario in ("deactivate", "spilled-then-host"):
        tw = twins(host_pages=1)
        other = tw.new()
        tw.fill(other, 5)                  # 2 pages, so the ids interleave
        sid = tw.new()
        tw.fill(sid, 10)                   # 3 pages, the last partial
        tw.both("deactivate", sid)         # 3 host pages, 2 spill
        tw.assert_same()
        assert _kinds(tw, sid) == ["vol", "vol", "host"]
        assert tw.t.metrics.count["kv_spills"] == 2
        if scenario == "spilled-then-host":
            tw.both("activate", sid)
            tw.assert_same()
            assert _kinds(tw, sid) == ["hbm"] * 3
            assert len(tw.launches) == 2   # before the 2nd fetch, at the end
    elif scenario in ("fully-spilled", "prefetched", "prefetch-wasted"):
        tw = twins()
        sid = tw.new()
        tw.fill(sid, 12)
        tw.both("deactivate", sid)
        assert _kinds(tw, sid) == ["vol"] * 3
        if scenario != "fully-spilled":
            tw.both("prefetch", sid)
            tw.assert_same()
            assert tw.t.metrics.count["kv_prefetch_issued"] == 3
        if scenario == "prefetch-wasted":
            tw.both("release", sid)
            tw.assert_same()
            assert tw.t.metrics.count["kv_prefetch_wasted"] == 3
            assert tw.tp.stats()["records"] == 0
            return
        tw.both("activate", sid)
        tw.assert_same()
        assert _kinds(tw, sid) == ["hbm"] * 3
        assert tw.t.metrics.count["kv_prefetch_hits"] == \
            (3 if scenario == "prefetched" else 0)
        assert tw.tp.stats()["records"] == 0
    elif scenario in ("host-then-spilled", "stall-after-promotion"):
        tw = twins(n_pages=4)
        sid = tw.new()
        tw.fill(sid, 12)                   # 3 pages
        tw.both("deactivate", sid)         # all spill
        hog = tw.new()
        tw.fill(hog, 16)                   # the whole pool
        tw.both("activate", sid)           # promotes page 0, then stalls
        tw.assert_same()
        assert _kinds(tw, sid) == ["host", "vol", "vol"]
        assert tw.t.metrics.count["activate_stalls"] == 1
        if scenario == "stall-after-promotion":
            for layer in (1, 0):           # hybrid: vol pages, no promotion
                tw.attend(layer, [sid, hog])
                tw.assert_same()
            assert _kinds(tw, sid) == ["host", "vol", "vol"]
            tw.both("release", hog)
            tw.both("release", sid)
            tw.assert_same()
            assert tw.tp.stats()["records"] == 0
        else:                              # a host page, then spilled ones
            tw.both("release", hog)
            tw.both("activate", sid)
            tw.assert_same()
            assert _kinds(tw, sid) == ["hbm"] * 3
    elif scenario == "wire-crc":
        tw = twins()
        sid = tw.new()
        tw.fill(sid, 12)
        tw.both("deactivate", sid)
        tw.tear_record(sid, 1)
        assert "failed its wire checksum" in tw.both("activate", sid)
        tw.assert_same()
        assert _kinds(tw, sid) == ["hbm", "vol", "vol"]
        assert tw.t.metrics.count["kv_restore_crc_errors"] == 1
        tw.both("release", sid)
        tw.assert_same()
    elif scenario == "transit-tear":
        tw = twins(host_pages=3)
        sid = tw.new()
        tw.fill(sid, 12)
        tw.both("deactivate", sid)         # 3 host pages: within budget
        tw.tear_host(sid, 1, 1, 0)         # corrupted before the spill
        other = tw.new()
        tw.fill(other, 12)
        tw.both("deactivate", other)       # 6 host pages: sid's 3 spill
        assert _kinds(tw, sid) == ["vol"] * 3
        assert "layer 1 page 1" in tw.both("activate", sid)
        tw.assert_same()
        assert _kinds(tw, sid) == ["hbm", "host", "vol"]
        assert tw.t.metrics.count["transit_crc_errors"] == 1
        assert tw.t.metrics.count["kv_restore_crc_errors"] == 0
        tw.both("release", sid)
        tw.assert_same()
    elif scenario == "dedup":
        tw = twins()
        a, b = tw.new(), tw.new()
        rng = np.random.default_rng(11)
        L, H, hd = SHAPE["n_layers"], SHAPE["n_kv_heads"], SHAPE["head_dim"]
        kv = rng.standard_normal((8, 2, L, H, hd)).astype(np.float32)
        for sid in (a, b):                 # the same tokens: same records
            for t in range(8):
                tw.t.append_token(sid, list(torch.tensor(kv[t, 0])),
                                  list(torch.tensor(kv[t, 1])))
                tw.j.append_token(sid, list(jnp.asarray(kv[t, 0])),
                                  list(jnp.asarray(kv[t, 1])))
        tw.both("deactivate", a)
        tw.both("deactivate", b)
        tw.assert_same()
        assert tw.t.metrics.count["kv_dedup_hits"] == 2
        tw.both("activate", a)
        tw.assert_same()
        assert tw.tp.stats()["records"] == 2
        tw.both("release", b)
        tw.both("release", a)
        tw.assert_same()
        assert tw.tp.stats()["records"] == 0
    else:                                  # bypass-prefill
        tw = twins(n_pages=2, host_pages=1)
        a = tw.new()
        tw.fill(a, 4)
        tw.both("deactivate", a)           # 1 host page: within budget
        b = tw.new()
        tw.fill(b, 8, bulk=True)           # the whole pool
        c = tw.new()
        tw.fill(c, 8, bulk=True)           # 2 bypass pages: a's spills
        tw.assert_same()
        assert _kinds(tw, a) == ["vol"]
        assert _kinds(tw, c) == ["host-fresh"] * 2
        assert tw.t.metrics.count["kv_spills"] == 1
        tw.attend(0, [b, c])
        tw.both("activate", a)             # pool full: promoted, stalled
        tw.assert_same()
        assert _kinds(tw, a) == ["host"]


# ------------------------------------------------------- wire compatibility
WIRE = dict(n_layers=2, n_kv_heads=2, head_dim=16, page_size=4, n_pages=4,
            max_pages_per_seq=4, read_tier_pages=0, host_pages=64)


def _inject_vol(cache, pager, raw: bytes, length: int) -> int:
    """A cold sequence whose one page is the record ``raw`` on ``pager``."""
    sid = cache.new_sequence()
    seq = cache.seqs[sid]
    seq.table, seq.length, seq.active = [("vol", pager.spill(raw))], length, \
        False
    return sid


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_pager_records_are_wire_compatible(monkeypatch, volumes, direction):
    """A page that one cache packed restores through the other's pager
    and cache bit for bit, with no crc error: the same pool page as the
    packing cache's own round trip."""
    monkeypatch.setattr(jkv, "gather_quantize_crc", _oracle_gather)
    monkeypatch.setattr(jkv, "scatter_dequantize_crc", _oracle_scatter)
    L, H, hd = WIRE["n_layers"], WIRE["n_kv_heads"], WIRE["head_dim"]
    kv = np.random.default_rng(21).standard_normal((4, 2, L, H, hd)) \
        .astype(np.float32) * np.float32(3.0)
    t = PagedKVCache(PagedCacheConfig(**WIRE, dtype=torch.float32),
                     pager=KVPager(volumes(), capacity_blocks=64),
                     device="cpu")
    j = JaxKVCache(JaxCacheConfig(**WIRE, dtype=jnp.float32),
                   pager=JaxPager(volumes(factory=jax_make_volume),
                                  capacity_blocks=64))
    for c, arr in ((t, torch.tensor), (j, jnp.asarray)):
        sid = c.new_sequence()
        for tok in range(4):
            c.append_token(sid, [arr(x) for x in kv[tok, 0]],
                           [arr(x) for x in kv[tok, 1]])
        c.deactivate(sid)
    raw = t._pack_page(t.seqs[0].table[0][1])
    assert raw == j._pack_page(j.seqs[0].table[0][1])
    # each layer's embedded crcs are the eager oracle's over its payloads
    for qk, _sk, ck, qv, _sv, cv in j._unpack_page(raw):
        assert ck == int(jref.transit_crc_ref(jnp.asarray(qk)[None])[0])
        assert cv == int(jref.transit_crc_ref(jnp.asarray(qv)[None])[0])
    src, dst = (j, t) if direction == "jax-to-port" else (t, j)
    sid = _inject_vol(dst, dst.pager, src._pack_page(src.seqs[0].table[0][1]),
                      4)
    src.activate(0)
    dst.activate(sid)
    for c in (t, j):
        assert c.metrics.count.get("kv_restore_crc_errors", 0) == 0
        assert c.metrics.count.get("transit_crc_errors", 0) == 0
    assert dst.metrics.count["kv_restores"] == 1
    ps, pd = src.seqs[0].table[0][1], dst.seqs[sid].table[0][1]
    for li in range(L):
        for pools_s, pools_d in ((src.k_pool, dst.k_pool),
                                 (src.v_pool, dst.v_pool)):
            assert np.array_equal(np.asarray(pools_s[li][ps]),
                                  np.asarray(pools_d[li][pd]))


# -------------------------------------------------------------- CLI, engine
def test_cli_spill_volume_prints_its_spill_line(capsys):
    serve_main(["--device", "cpu", "--spill-volume", "--host-pages", "1",
                "--suspend-every", "3", "--requests", "4", "--max-new", "8"])
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines() if ln.startswith("[spill]"))
    spills = int(re.search(r"spills (\d+)", line).group(1))
    restores = int(re.search(r"restores (\d+)", line).group(1))
    assert spills > 0 and restores > 0
    assert re.search(r"crc errors 0$", line)
    assert "[serve] qwen25-smoke on cpu: 4 requests, 32 tokens" in out


@pytest.mark.parametrize("arch,blocks,slots,window", [
    ("qwen2.5-3b", 74, 64, 1024), ("phi3-mini-3.8b", 770, 128, 8192)])
def test_cli_sizes_the_volume_from_the_record(arch, blocks, slots, window):
    """At full width a record is 74 (qwen2.5-3b) or 770 (phi3-mini-3.8b)
    blocks of 4096: the journal commits one whole record, the in-flight
    window holds every record of the prefetched sequences with room for
    spill writes, and the pager's half of the volume every record."""
    from repro_torch.launch.serve import record_blocks, spill_volume_kwargs
    cfg = get_config(arch)
    assert record_blocks(cfg, 16) == blocks
    kw = spill_volume_kwargs(cfg, 16, 40, 5, 2)
    assert kw["journal_slots"] == slots and slots * 8 >= blocks
    assert kw["max_inflight"] == window >= 2 * 5 * blocks + 64
    assert kw["n_lbas"] // 2 >= 40 * blocks
    L, D = cfg.n_layers, cfg.n_kv_heads * cfg.hd
    assert -(-(8 + L * (8 + 2 * 16 * (D + 4))) // 4096) == blocks


def test_engine_suspend_resume_through_the_pager(volumes):
    """Suspends through a pager with no host budget: every suspended page
    descends to the volume and comes back; the greedy tokens equal the
    same run with an unbounded host tier and no pager."""
    cfg = get_config("qwen2.5-3b", smoke=True, dtype=torch.float32)
    params = init_lm(cfg, torch.Generator().manual_seed(0))

    def run(pager):
        cache_cfg = PagedCacheConfig(
            n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
            head_dim=cfg.hd, page_size=4, n_pages=16,
            host_pages=0 if pager else 1 << 30, max_pages_per_seq=16)
        eng = ServeEngine(cfg, params, cache_cfg=cache_cfg, max_batch=2,
                          pager=pager, prefetch_depth=2, device="cpu")
        r1 = eng.submit(list(range(2, 14)), max_new_tokens=6)
        r2 = eng.submit(list(range(3, 15)), max_new_tokens=6)
        eng.step()                                 # both admitted
        eng.suspend(eng.running[0])                # preempt: spill to vol
        if pager is not None:
            assert eng.metrics.count["kv_spills"] > 0
        assert eng.suspended
        eng.run(max_ticks=200)                     # resumes + finishes
        assert r1.done and r2.done
        assert eng.cache.free_pages() == 16 and len(eng.cache.host) == 0
        return eng, [r1.out_tokens, r2.out_tokens]

    pager = KVPager(volumes(n_lbas=4096), capacity_blocks=2048)
    eng, tokens = run(pager)
    _, ref_tokens = run(None)
    assert tokens == ref_tokens
    assert all(len(t) == 6 for t in tokens)
    count = eng.metrics.count
    assert count["resumes"] >= 1 and count["kv_restores"] > 0
    assert count["kv_prefetch_issued"] > 0
    assert count["kv_prefetch_hits"] == count["kv_restores"]
    assert count["kv_restore_crc_errors"] == 0
    assert count.get("transit_crc_errors", 0) == 0
    assert pager.stats()["records"] == 0
