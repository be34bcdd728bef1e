"""The port's KV cache with an eviction pool (``evict_pool=``) on the CPU.

``deactivate`` queues one item per device page; the pool's workers hand
them back in batches to ``_evict_slot`` / ``_evict_slots``.  A stub pool
(``register`` and ``submit`` that only record the items) makes the
batches deterministic: the port's cache and the JAX cache (its codec on
the eager ``repro.kernels.ref`` oracles, since its Pallas codec does not
trace on this jax) take the same batches and end in equal states, and the
port pages each batch out in one codec launch.  Then PR 10's regressions
with and without a real pool, the release race that the reference loses
(a released sequence's queued page-out frees its page a second time), and
an engine run over a real 4-worker pool whose tokens equal a run with no
pool.  Every pool and volume is closed by a fixture, every wait bounded."""
import sys
import threading

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
from repro_torch.core.metrics import Metrics
from repro_torch.kernels import _build
from repro_torch.models.transformer import init_lm
from repro_torch.serve import (KVPager, PagedCacheConfig, PagedKVCache,
                               PagedLM, ServeEngine)
from repro_torch.serve import kvcache as tkv
from repro_torch.volume.evict_pool import SharedEvictionPool
from repro_torch.volume.volume import make_volume

SHAPE = dict(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4)
COUNTERS = ("pages_out", "pages_in", "fused_kernel_passes",
            "fused_kernel_bytes", "evict_batches", "evict_skipped",
            "activate_stalls", "transit_crc_errors", "kv_spills",
            "kv_spill_dedup_hits")


class StubPool:
    """An eviction pool that runs nothing: ``register`` and ``submit``
    record, and the test hands the items to the cache's hooks itself."""

    def __init__(self) -> None:
        self.registered = []
        self.items = []

    def register(self, cache, socket: int = 0) -> None:
        self.registered.append(cache)

    def submit(self, cache, item) -> None:
        self.items.append((cache, item))

    def take(self, cache) -> list:
        mine = [it for c, it in self.items if c is cache]
        self.items = [(c, it) for c, it in self.items if c is not cache]
        return mine


@pytest.fixture
def pools():
    """A factory of real eviction pools, every one closed at the end."""
    made = []

    def make(n_workers=4, batch_max=8):
        pool = SharedEvictionPool(n_workers, name="test", batch_max=batch_max)
        made.append(pool)
        return pool
    yield make
    for pool in made:
        pool.close()


@pytest.fixture
def volumes():
    """A factory of volumes (the port's by default), every one closed."""
    made = []

    def make(factory=make_volume):
        vol = factory(n_lbas=1024, n_shards=2, aio_workers=2,
                      cache_bytes=1 << 22)
        made.append(vol)
        return vol
    yield make
    for vol in made:
        vol.close()


def _cfg(**kw):
    base = dict(SHAPE, n_pages=16, host_pages=64, max_pages_per_seq=8,
                read_tier_pages=8, dtype=torch.float32)
    base.update(kw)
    return PagedCacheConfig(**base)


def _fill(cache, sid, n_tokens, rng):
    L, H, hd = cache.cfg.n_layers, cache.cfg.n_kv_heads, cache.cfg.head_dim
    for _ in range(n_tokens):
        k = torch.tensor(rng.normal(size=(H, hd)), dtype=torch.float32)
        v = torch.tensor(rng.normal(size=(H, hd)), dtype=torch.float32)
        cache.append_token(sid, [k] * L, [v] * L)


@pytest.mark.parametrize("pager", [False, True])
def test_cache_registers_with_an_eviction_pool(volumes, pager):
    """The pool is ported: the cache registers with it in its constructor,
    beside a pager or without one, and its deactivate submits one item
    per device page to it."""
    pool = StubPool()
    kv_pager = KVPager(volumes(), capacity_blocks=256) if pager else None
    c = PagedKVCache(_cfg(), metrics=Metrics(), evict_pool=pool,
                     pager=kv_pager, device="cpu")
    assert pool.registered == [c] and c.pager is kv_pager
    sid = c.new_sequence()
    _fill(c, sid, 9, np.random.default_rng(0))     # 3 pages
    c.deactivate(sid)
    assert [li for _, li in pool.take(c)] == [0, 1, 2]
    assert c._inflight_evictions == 3
    assert [e[0] for e in c.seqs[sid].table] == ["hbm"] * 3


# --------------------------------------- batches against the reference's
def _oracle_gather(pool, ids):
    q, s = jref.gather_quantize_ref(pool, ids)
    return q, s, jref.transit_crc_ref(q)


def _oracle_scatter(pool, ids, q, s):
    return (jref.scatter_dequantize_ref(pool, ids, q, s),
            jref.transit_crc_ref(q))


class _Twins:
    """The port's cache and the JAX cache, each with a stub pool (and,
    with ``volumes``, a pager on its own package's volume), driven by the
    same calls."""

    def __init__(self, volumes=None, **kw):
        base = dict(SHAPE, n_pages=16, max_pages_per_seq=8,
                    read_tier_pages=8)
        base.update(kw)
        self.tpool, self.jpool = StubPool(), StubPool()
        self.tp = self.jp = None
        if volumes is not None:
            self.tp = KVPager(volumes(), capacity_blocks=256)
            self.jp = JaxPager(volumes(factory=jax_make_volume),
                               capacity_blocks=256)
        self.t = PagedKVCache(PagedCacheConfig(**base, dtype=torch.float32),
                              metrics=Metrics(), evict_pool=self.tpool,
                              pager=self.tp, device="cpu")
        self.j = JaxKVCache(JaxCacheConfig(**base, dtype=jnp.float32),
                            evict_pool=self.jpool, pager=self.jp)
        self.rng = np.random.default_rng(7)
        self.launches = 0                          # the port's page-outs

    def new(self) -> int:
        sid = self.t.new_sequence()
        assert self.j.new_sequence() == sid
        return sid

    def fill(self, sid, n_tokens) -> None:
        L, H, hd = SHAPE["n_layers"], SHAPE["n_kv_heads"], SHAPE["head_dim"]
        for _ in range(n_tokens):
            kv = self.rng.standard_normal((2, L, H, hd)).astype(np.float32)
            self.t.append_token(sid, list(torch.tensor(kv[0])),
                                list(torch.tensor(kv[1])))
            self.j.append_token(sid, list(jnp.asarray(kv[0])),
                                list(jnp.asarray(kv[1])))

    def both(self, method, sid) -> None:
        getattr(self.t, method)(sid)
        getattr(self.j, method)(sid)

    def queued(self) -> tuple[list, list]:
        """The items both caches submitted since the last call."""
        t, j = self.tpool.take(self.t), self.jpool.take(self.j)
        assert [(s.seq_id, li) for s, li in t] == \
            [(s.seq_id, li) for s, li in j]
        return t, j

    def evict(self, t_items, j_items, complete: bool = True) -> int:
        """Hand one batch to both caches' batch hook, as a worker does
        (and then complete each item); returns the port's launches."""
        n0 = self.launches
        self.t._evict_slots(t_items)
        self.j._evict_slots(j_items)
        if complete:
            for c, items in ((self.t, t_items), (self.j, j_items)):
                for _ in items:
                    c._complete_eviction()
        return self.launches - n0

    def assert_same(self) -> None:
        t, j = self.t, self.j
        assert list(t._free) == list(j._free)
        assert len(t._free) == len(set(t._free))
        assert ({k: t.metrics.count.get(k, 0) for k in COUNTERS}
                == {k: j.metrics.count.get(k, 0) for k in COUNTERS})
        assert t._inflight_evictions == j._inflight_evictions
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
                else:
                    assert et[1] == ej[1]
        if self.tp is not None:
            a, b = self.tp, self.jp
            assert (a._free_slots, a._next_handle, a._by_key) == \
                (b._free_slots, b._next_handle, b._by_key)
            assert a._records.keys() == b._records.keys()
            for h, ra in a._records.items():
                rb = b._records[h]
                for tk in (*ra.spill_tickets, *rb.spill_tickets):
                    (a if tk in ra.spill_tickets else b).vol.wait(tk)
                for i in range(ra.n_blocks):
                    assert np.array_equal(a.vol.read(ra.lba + i),
                                          b.vol.read(rb.lba + i))


@pytest.fixture
def twins(monkeypatch):
    monkeypatch.setattr(jkv, "gather_quantize_crc", _oracle_gather)
    monkeypatch.setattr(jkv, "scatter_dequantize_crc", _oracle_scatter)
    made = []
    gather = tkv.gather_quantize_crc_units

    def counted(*args):
        for tw in made:
            tw.launches += 1
        return gather(*args)
    monkeypatch.setattr(tkv, "gather_quantize_crc_units", counted)

    def make(*args, **kw):
        tw = _Twins(*args, **kw)
        made.append(tw)
        return tw
    return make


def _perm(items, order):
    return [items[i] for i in order]


@pytest.mark.parametrize("case", ["batches 1-3-8", "skips", "spills"])
def test_evict_slots_end_state_equals_the_reference(twins, volumes, case):
    if case == "batches 1-3-8":
        tw = twins()
        sids = [tw.new() for _ in range(3)]
        for sid, n in zip(sids, (13, 16, 14)):     # 4 pages each
            tw.fill(sid, n)
        for sid in sids:
            tw.both("deactivate", sid)
        t, j = tw.queued()
        assert len(t) == 12
        # an order that mixes the sequences inside every batch
        order = list(np.random.default_rng(3).permutation(12))
        t, j = _perm(t, order), _perm(j, order)
        for lo, hi in ((0, 1), (1, 4), (4, 12)):
            assert hi - lo == 1 or len({s.seq_id for s, _ in t[lo:hi]}) > 1
            assert tw.evict(t[lo:hi], j[lo:hi]) == 1
            tw.assert_same()
        assert tw.t.metrics.count["pages_out"] == 12
        assert tw.t.metrics.count["evict_batches"] == 3
        assert tw.t.free_pages() == 16
        for sid in sids:                           # and back in
            tw.both("activate", sid)
            tw.assert_same()
        assert tw.t.metrics.count["pages_in"] == 12
    elif case == "skips":
        tw = twins()
        a, b = tw.new(), tw.new()
        tw.fill(a, 8)                              # 2 pages
        tw.fill(b, 12)                             # 3 pages
        tw.both("deactivate", a)
        ta, ja = tw.queued()
        # a's page-outs never ran (a pool that dropped them), and a
        # resumed: its queued items now belong to an active sequence
        for c in (tw.t, tw.j):
            for _ in ta:
                c._complete_eviction()
        tw.both("activate", a)
        tw.both("deactivate", b)
        tw.both("deactivate", b)                   # queues b's pages twice
        tb, jb = tw.queued()
        assert len(tb) == 6
        assert tw.evict(ta + tb[:4], ja + jb[:4], complete=False) == 1
        for c, items in ((tw.t, tb[:4]), (tw.j, jb[:4])):
            for _ in items:
                c._complete_eviction()
        tw.assert_same()
        assert tw.t.metrics.count["evict_skipped"] == 3   # a's 2, b's dup
        assert tw.evict(tb[4:], jb[4:]) == 0       # all paged already
        tw.assert_same()
        assert tw.t.metrics.count["evict_skipped"] == 5
        assert tw.t.metrics.count["pages_out"] == 3
        assert [e[0] for e in tw.t.seqs[a].table] == ["hbm", "hbm"]
    else:                                          # spills to the volume
        tw = twins(volumes, host_pages=1)
        a, b = tw.new(), tw.new()
        tw.fill(a, 10)                             # 3 pages
        tw.fill(b, 6)                              # 2 pages
        tw.both("deactivate", a)
        tw.both("deactivate", b)
        t, j = tw.queued()
        assert tw.evict(t[:3], j[:3]) == 1
        tw.assert_same()
        assert tw.t.metrics.count["kv_spills"] == 2
        assert tw.evict(t[3:], j[3:]) == 1
        tw.assert_same()
        assert tw.t.metrics.count["kv_spills"] == 4
        for sid in (a, b):
            tw.both("activate", sid)
            tw.assert_same()
        assert tw.t.metrics.count["pages_in"] == 5


def test_single_item_hook_equals_the_reference(twins):
    """``_evict_slot`` (a batch of one, as a worker hands it) pages out
    and counts no batch; a skipped item changes nothing else."""
    tw = twins()
    sid = tw.new()
    tw.fill(sid, 6)
    tw.both("deactivate", sid)
    t, j = tw.queued()
    for ti, ji in zip(t + t[:1], j + j[:1]):       # the last is a repeat
        tw.t._evict_slot(ti)
        tw.j._evict_slot(ji)
        tw.assert_same()
    assert tw.launches == 2
    assert tw.t.metrics.count.get("evict_batches", 0) == 0
    assert tw.t.metrics.count["evict_skipped"] == 1


# ---------------------------------------- the release race of the reference
def test_released_sequence_page_outs_are_skipped_not_double_freed(twins):
    """``_retire`` calls ``deactivate`` and then ``release`` at once: with
    a pool, the page-outs are still queued when ``release`` frees the
    pages.  The port skips them; the reference pages out a free page and
    frees it a second time."""
    tw = twins()
    keep, sid = tw.new(), tw.new()
    tw.fill(keep, 4)
    tw.fill(sid, 10)                               # 3 pages
    tw.both("deactivate", sid)
    tw.both("release", sid)
    t, j = tw.queued()
    assert len(t) == 3
    assert tw.evict(t, j) == 0                     # no launch on the port
    port = tw.t
    assert len(port._free) == len(set(port._free)) == 15
    assert port.metrics.count["evict_skipped"] == 3
    assert port.metrics.count.get("pages_out", 0) == 0
    assert len(port.host) == 0 and port._inflight_evictions == 0
    ref = tw.j
    assert len(ref._free) == 18 and len(set(ref._free)) == 15
    assert len(ref.host) == 3 * 2 * SHAPE["n_layers"]  # nobody frees these


# ------------------------------------------- PR 10's regressions on the pool
@pytest.mark.parametrize("with_pool", [False, True])
def test_concurrent_deactivate_never_double_frees(pools, with_pool):
    """Racing deactivates of the same sequences from 4 threads, paged out
    on the caller's thread or by a 4-worker pool: no pool page is freed
    twice and each page is packed to the host tier once."""
    m = Metrics()
    c = PagedKVCache(_cfg(n_pages=32, read_tier_pages=0), metrics=m,
                     evict_pool=pools() if with_pool else None, device="cpu")
    rng = np.random.default_rng(0)
    sids = []
    for _ in range(6):
        sid = c.new_sequence()
        _fill(c, sid, 8, rng)                      # 2 pages each
        sids.append(sid)
    barrier = threading.Barrier(4, timeout=10)

    def deactivate_all():
        barrier.wait()
        for sid in sids:
            c.deactivate(sid)

    threads = [threading.Thread(target=deactivate_all) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
        assert not th.is_alive()
    assert c.drain_evictions(timeout=10)
    assert len(c._free) == len(set(c._free)), "pool page double-freed"
    resident = sum(1 for s in c.seqs.values()
                   for e in s.table if e[0] == "hbm")
    assert len(c._free) + resident == c.cfg.n_pages == 32
    assert len(c.host) == 12 * 2 * c.cfg.n_layers
    assert m.count["pages_out"] == 12


@pytest.mark.parametrize("with_pool", [False, True])
def test_drain_evictions_timeout_is_loud(pools, with_pool):
    c = PagedKVCache(_cfg(), metrics=Metrics(),
                     evict_pool=pools() if with_pool else None, device="cpu")
    with c._evict_cv:
        c._inflight_evictions += 1                 # a stuck page-out
    with pytest.raises(TimeoutError, match="still in flight"):
        c.drain_evictions(timeout=0.05)
    assert c.drain_evictions(timeout=0.05, raise_on_timeout=False) is False
    c._complete_eviction()
    assert c.drain_evictions(timeout=1.0) is True


def test_activate_waits_for_queued_page_outs(pools):
    """A resume right after a suspend finds every page-out done: activate
    drains the pool before it reads the table."""
    c = PagedKVCache(_cfg(), metrics=Metrics(), evict_pool=pools(),
                     device="cpu")
    sid = c.new_sequence()
    _fill(c, sid, 12, np.random.default_rng(1))
    gate = threading.Event()
    page_out = c._page_out_locked

    def slow(items):
        gate.wait(timeout=5)                       # hold the workers back
        page_out(items)
    c._page_out_locked = slow
    c.deactivate(sid)
    threading.Timer(0.2, gate.set).start()
    c.activate(sid)
    assert c._inflight_evictions == 0
    assert c.metrics.count["pages_out"] == c.metrics.count["pages_in"] == 3
    assert [e[0] for e in c.seqs[sid].table] == ["hbm"] * 3


# ------------------------------------------------- an engine over a pool
def _pool_engine(cfg, params, pool, device="cpu"):
    """A ServeEngine whose PagedLM runs over a cache with the eviction
    pool (the engine itself takes no pool, as the reference's does not)."""
    cc = PagedCacheConfig(n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.hd, page_size=4, n_pages=64,
                          max_pages_per_seq=16, dtype=cfg.dtype)
    eng = ServeEngine(cfg, params, cache_cfg=cc, max_batch=2, device=device)
    if pool is not None:
        eng.cache = PagedKVCache(cc, metrics=eng.metrics, evict_pool=pool,
                                 device=device)
        eng.lm = PagedLM(cfg, params, eng.cache)
    return eng


def _drive(eng, vocab):
    rng = np.random.default_rng(2)
    reqs = [eng.submit(rng.integers(2, vocab, size=n).tolist(),
                       max_new_tokens=7) for n in (9, 14, 6, 11)]
    ticks = 0
    while eng.queue or eng.running or eng.suspended:
        eng.step()
        ticks += 1
        if eng.running and ticks % 3 == 0:
            eng.suspend(eng.running[0])
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "deepseek-coder-33b"])
def test_engine_order_run_over_a_pool_equals_no_pool(pools, arch):
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    eng = _pool_engine(cfg, params, pools(n_workers=4))
    got = _drive(eng, cfg.vocab)
    assert eng.cache.drain_evictions(timeout=10)
    ref_eng = _pool_engine(cfg, params, None)
    assert got == _drive(ref_eng, cfg.vocab)
    count = eng.metrics.count
    assert count["suspends"] == ref_eng.metrics.count["suspends"] > 0
    assert count["pages_in"] == ref_eng.metrics.count["pages_in"] > 0
    assert count.get("transit_crc_errors", 0) == 0
    assert len(eng.cache._free) == len(set(eng.cache._free)) == 64
    assert len(eng.cache.host) == 0


# ------------------------------------------------------ the launch counter
def test_launch_counter_loses_no_update_across_threads():
    """Pool workers count their codec launches beside the decode thread:
    8 threads x 2000 counts with a short switch interval lose none."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launch_counts()
        threads = [threading.Thread(target=lambda: [
            _build.count_launch("x") for _ in range(2000)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        assert _build.launch_counts()["x"] == 16000
    finally:
        sys.setswitchinterval(old)
        _build.reset_launch_counts()
