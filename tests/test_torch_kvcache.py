"""The port's PagedKVCache on the CPU (plain codec and attention) against
the JAX cache's layout and oracles: pack/unpack byte-identical, page-out
q/scales/crc bit-identical to ``repro.kernels.ref``, the page-out ->
page-in round trip, conditional bypass, release accounting,
max_pages_per_seq, and a torn payload on page-in.

The port pages a sequence out, or in, with one codec call over every
page, layer and K/V; the JAX cache loops page by page, layer by layer.
``test_transit_end_state_equals_the_reference_loop`` runs both caches
through the same page-outs, page-ins, torn payloads and stalls and holds
every end state equal: tables, the free list in order, host entries,
pool pages, pager bytes and counters.  The JAX cache's Pallas codec does
not trace on this jax, so there it calls the eager ``repro.kernels.ref``
oracles, which the codec equals bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.serve import kvcache as jkv
from repro.serve.kvcache import PagedCacheConfig as JaxCacheConfig
from repro.serve.kvcache import PagedKVCache as JaxKVCache
from repro_torch.core.metrics import Metrics
from repro_torch.kernels import ref as tref
from repro_torch.serve import PagedCacheConfig, PagedKVCache

SHAPE = dict(n_layers=2, n_kv_heads=2, head_dim=8, page_size=4)


def _cache(**kw) -> PagedKVCache:
    base = dict(SHAPE, n_pages=8, max_pages_per_seq=8,
                read_tier_pages=8, dtype=torch.float32)
    base.update(kw)
    return PagedKVCache(PagedCacheConfig(**base), metrics=Metrics(),
                        device="cpu")


def _fill(cache, sid, n_tokens, rng):
    """n_tokens appends with the same K/V in every layer; returns them
    as (n_tokens, Hkv, hd) arrays."""
    L, H, hd = cache.cfg.n_layers, cache.cfg.n_kv_heads, cache.cfg.head_dim
    ks, vs = [], []
    for _ in range(n_tokens):
        k = rng.standard_normal((H, hd)).astype(np.float32)
        v = rng.standard_normal((H, hd)).astype(np.float32)
        cache.append_token(sid, [torch.tensor(k)] * L, [torch.tensor(v)] * L)
        ks.append(k)
        vs.append(v)
    return np.stack(ks), np.stack(vs)


def test_pack_unpack_byte_identical_to_jax_layout():
    """The same host-tier entries serialize to the same bytes in both
    caches, and each cache unpacks the other's bytes to the same arrays."""
    rng = np.random.default_rng(0)
    jc = JaxKVCache(JaxCacheConfig(**SHAPE, n_pages=4, read_tier_pages=0))
    tc = _cache(n_pages=4, read_tier_pages=0)
    D = SHAPE["n_kv_heads"] * SHAPE["head_dim"]
    handles_j, handles_t = [], []
    for li in range(SHAPE["n_layers"]):
        pair_j, pair_t = [], []
        for _ in ("k", "v"):
            q = rng.integers(-127, 128, (SHAPE["page_size"], D)).astype(np.int8)
            s = rng.random(SHAPE["page_size"]).astype(np.float32)
            crc = int(jref.transit_crc_ref(q[None])[0])
            pair_j.append(jc.host.put(li, q, s, crc))
            pair_t.append(tc.host.put(li, q, s, crc))
        handles_j.append(tuple(pair_j))
        handles_t.append(tuple(pair_t))
    raw = tc._pack_page(handles_t)
    assert raw == jc._pack_page(handles_j)
    for got, exp in zip(tc._unpack_page(raw), jc._unpack_page(raw)):
        for a, b in zip(got, exp):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_page_out_matches_jax_codec_and_roundtrips():
    """deactivate packs each page with the fused codec: host entries equal
    gather_quantize_ref + transit_crc_ref of the pool page bit for bit;
    activate restores within one quantization step, with no crc error."""
    rng = np.random.default_rng(1)
    c = _cache()
    sid = c.new_sequence()
    ks, _ = _fill(c, sid, 10, rng)                 # 3 pages, last partial
    pages = [e[1] for e in c.seqs[sid].table]
    pools = {(li, kv, p): (c.k_pool if kv == 0 else c.v_pool)[li][p]
             .reshape(4, -1).numpy().copy()
             for li in range(2) for kv in range(2) for p in pages}
    c.deactivate(sid)
    assert c.metrics.count["pages_out"] == 3
    assert c.free_pages() == 8
    assert c.metrics.count["fused_kernel_passes"] == 3 * 2 * 2
    for logical, page in enumerate(pages):
        for li, pair in enumerate(c.seqs[sid].table[logical][1]):
            for kv, h in enumerate(pair):
                q, s, crc = c.host.get(li, h)
                qr, sr = jref.gather_quantize_ref(
                    jnp.asarray(pools[li, kv, page])[None],
                    jnp.asarray([0], jnp.int32))
                assert np.array_equal(q, np.asarray(qr)[0])
                assert np.array_equal(s, np.asarray(sr)[0])
                assert crc == int(jref.transit_crc_ref(qr)[0])
                assert q.flags.owndata and s.flags.owndata
    c.activate(sid)
    assert c.metrics.count["pages_in"] == 3
    assert c.metrics.count.get("transit_crc_errors", 0) == 0
    assert len(c.host) == 0
    got = np.concatenate([c.k_pool[1][e[1]].numpy()
                          for e in c.seqs[sid].table])[:10]
    # one scale per token row of the page, over all kv heads
    step = np.abs(ks).max(axis=(1, 2), keepdims=True) / 127.0
    assert (np.abs(got - ks) <= step * 0.75 + 1e-7).all()


def test_conditional_bypass_under_pool_pressure_and_hybrid_attention():
    """A pool too small for the sequence sends its later pages to the
    host tier; attention then runs the hybrid path over every tier and
    agrees with the plain attention over the dense K/V."""
    rng = np.random.default_rng(2)
    c = _cache(n_pages=2)
    sid = c.new_sequence()
    ks, vs = _fill(c, sid, 11, rng)                # 3 pages, pool holds 2
    assert c.metrics.count["bypass_pages"] == 1
    assert [e[0] for e in c.seqs[sid].table] == ["hbm", "hbm", "host-fresh"]
    q = torch.tensor(rng.standard_normal((1, 4, 8)), dtype=torch.float32)
    out = c.attention(0, q, [sid])
    assert c.metrics.count["hybrid_attention"] == 1
    exp = tref.paged_attention_ref(
        q, torch.tensor(ks)[None], torch.tensor(vs)[None],
        torch.zeros((1, 1), dtype=torch.int32),
        torch.tensor([11], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), exp.numpy(), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_hybrid_attention_unchanged_by_the_paged_view(q_dtype):
    """The hybrid path lays the f32 view of every tier out as a pool of
    ``page_size`` pages for the paged-attention op.  Its output is bit for
    bit the reference's formulation (the plain version over one page of
    S tokens per sequence, ``repro.serve.kvcache``), and within 2e-5 of
    the JAX cache's hybrid attention on the same tokens."""
    rng = np.random.default_rng(12)
    c = _cache(n_pages=2)
    jc = JaxKVCache(JaxCacheConfig(**SHAPE, n_pages=2, max_pages_per_seq=8,
                                   read_tier_pages=8, dtype=jnp.float32))
    sids = [c.new_sequence() for _ in range(2)]
    jsids = [jc.new_sequence() for _ in range(2)]
    L, H, hd = SHAPE["n_layers"], SHAPE["n_kv_heads"], SHAPE["head_dim"]
    dense = {sid: ([], []) for sid in sids}
    for sid, jsid, n in zip(sids, jsids, (11, 6)):
        for _ in range(n):
            k = rng.standard_normal((H, hd)).astype(np.float32)
            v = rng.standard_normal((H, hd)).astype(np.float32)
            c.append_token(sid, [torch.tensor(k)] * L, [torch.tensor(v)] * L)
            jc.append_token(jsid, [jnp.asarray(k)] * L, [jnp.asarray(v)] * L)
            dense[sid][0].append(k)
            dense[sid][1].append(v)
    assert c.metrics.count["bypass_pages"] == 3
    q32 = rng.standard_normal((2, 4, hd)).astype(np.float32)
    q = torch.tensor(q32).to(q_dtype)
    out = c.attention(1, q, sids)
    assert c.metrics.count["hybrid_attention"] == 1
    assert out.dtype == q_dtype and out.shape == (2, 4, hd)
    S = 3 * SHAPE["page_size"]
    kv = np.zeros((2, 2, S, H, hd), np.float32)
    for bi, sid in enumerate(sids):
        for j in range(2):
            toks = np.stack(dense[sid][j])
            kv[j, bi, :len(toks)] = toks
    before = tref.paged_attention_ref(
        q, torch.tensor(kv[0]), torch.tensor(kv[1]),
        torch.arange(2, dtype=torch.int32)[:, None],
        torch.tensor([11, 6], dtype=torch.int32))
    assert torch.equal(out, before)
    exp = jc.attention(1, jnp.asarray(q32), jsids)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(exp),
                               atol=2e-5 if q_dtype == torch.float32
                               else 2e-2, rtol=2e-5)


def test_release_returns_every_page():
    rng = np.random.default_rng(3)
    c = _cache(n_pages=4)
    sids = [c.new_sequence() for _ in range(3)]
    for sid in sids:
        _fill(c, sid, 6, rng)                      # 2 pages each: 2 bypass
    assert c.metrics.count["bypass_pages"] == 2
    c.deactivate(sids[0])                          # device pages -> host
    c.release(sids[0])
    c.release(sids[1])
    c.release(sids[2])
    assert c.free_pages() == 4
    assert len(c.host) == 0
    assert c.seqs == {}


def test_max_pages_per_seq_enforced_without_bypass():
    c = _cache(max_pages_per_seq=2, conditional_bypass=False, n_pages=16)
    sid = c.new_sequence()
    _fill(c, sid, 8, np.random.default_rng(0))     # exactly at the bound
    with pytest.raises(MemoryError, match="max_pages_per_seq"):
        _fill(c, sid, 1, np.random.default_rng(1))


def test_long_sequence_bypasses_and_decodes_via_hybrid_path():
    c = _cache(max_pages_per_seq=2, n_pages=16)
    sid = c.new_sequence()
    _fill(c, sid, 11, np.random.default_rng(0))    # 3 pages: 1 past bound
    assert c.metrics.count["long_seq_bypass"] > 0
    assert c.seqs[sid].table[2][0] == "host-fresh"
    with pytest.raises(ValueError, match="max_pages_per_seq"):
        c.table_for([sid])
    out = c.attention(0, torch.ones((1, 2, 8)), [sid])
    assert torch.isfinite(out).all()
    assert c.metrics.count["hybrid_attention"] == 1


def test_torn_payload_raises_and_returns_the_pool_page():
    """A byte flipped in the host tier after page-out fails the restore's
    checksum: IOError, the counter moves, the allocated pool page goes back
    to the free list and the host entries stay for a retry."""
    rng = np.random.default_rng(4)
    c = _cache()
    sid = c.new_sequence()
    _fill(c, sid, 4, rng)
    c.deactivate(sid)
    hk, _hv = c.seqs[sid].table[0][1][1]
    q, s, crc = c.host.get(1, hk)
    torn = q.copy()
    torn[2, 5] ^= 0x10
    c.host.pages[(1, hk)] = (torn, s, crc)
    free_before, host_before = c.free_pages(), len(c.host)
    with pytest.raises(IOError, match="checksum mismatch"):
        c.activate(sid)
    assert c.metrics.count["transit_crc_errors"] == 1
    assert c.free_pages() == free_before
    assert len(c.host) == host_before
    assert c.seqs[sid].table[0][0] == "host"
    c.host.pages[(1, hk)] = (q, s, crc)            # repaired: retry works
    c.activate(sid)
    assert c.seqs[sid].table[0][0] == "hbm"


def test_prefill_bulk_write_equals_token_appends():
    """append_tokens (the prefill's one indexed copy per layer) leaves the
    pools, tables and host pages as T append_token calls do, bypass
    included."""
    rng = np.random.default_rng(5)
    L, H, hd = SHAPE["n_layers"], SHAPE["n_kv_heads"], SHAPE["head_dim"]
    ks = [torch.tensor(rng.standard_normal((10, H, hd)), dtype=torch.float32)
          for _ in range(L)]
    vs = [torch.tensor(rng.standard_normal((10, H, hd)), dtype=torch.float32)
          for _ in range(L)]
    a, b = _cache(n_pages=2), _cache(n_pages=2)
    sa, sb = a.new_sequence(), b.new_sequence()
    a.append_tokens(sa, ks, vs)
    for t in range(10):
        b.append_token(sb, [k[t] for k in ks], [v[t] for v in vs])
    assert a.seqs[sa].length == b.seqs[sb].length == 10
    for ea, eb in zip(a.seqs[sa].table, b.seqs[sb].table):
        assert ea[0] == eb[0]
        if ea[0] == "hbm":
            assert ea[1] == eb[1]
        else:
            assert np.array_equal(ea[1]["k"], eb[1]["k"])
            assert np.array_equal(ea[1]["v"], eb[1]["v"])
    for li in range(L):
        assert torch.equal(a.k_pool[li], b.k_pool[li])
        assert torch.equal(a.v_pool[li], b.v_pool[li])


@pytest.mark.parametrize("hook", ["pager", "evict_pool"])
def test_unported_spill_hooks_raise(hook):
    """The eviction pool is not ported: the cache refuses one instead of
    ignoring it, with or without the (ported) volume pager beside it, and
    the refusal names the pool only."""
    cfg = PagedCacheConfig(**SHAPE, n_pages=4, dtype=torch.float32)
    kw = {"evict_pool": object()}
    if hook == "pager":
        kw["pager"] = object()
        assert PagedKVCache(cfg, device="cpu", pager=kw["pager"]).pager \
            is kw["pager"]
    with pytest.raises(NotImplementedError) as err:
        PagedKVCache(cfg, device="cpu", **kw)
    assert "eviction pool" in str(err.value)
    assert "pager" not in str(err.value)


# ------------------------------------------ batched transit vs reference loop
COUNTERS = ("pages_out", "pages_in", "activate_stalls", "transit_crc_errors",
            "fused_kernel_passes", "fused_kernel_bytes", "bypass_pages")


def _oracle_gather(pool, ids):
    q, s = jref.gather_quantize_ref(pool, ids)
    return q, s, jref.transit_crc_ref(q)


def _oracle_scatter(pool, ids, q, s):
    return (jref.scatter_dequantize_ref(pool, ids, q, s),
            jref.transit_crc_ref(q))


class _Twins:
    """The port's cache and the JAX cache, driven by the same calls."""

    def __init__(self, **kw):
        self.t = _cache(**kw)
        base = dict(SHAPE, n_pages=8, max_pages_per_seq=8, read_tier_pages=8)
        base.update(kw, dtype=jnp.float32)
        self.j = JaxKVCache(JaxCacheConfig(**base))
        self.rng = np.random.default_rng(7)

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
        """Call ``method`` on both; they raise the same error or none."""
        errors = []
        for c in (self.t, self.j):
            try:
                getattr(c, method)(sid)
                errors.append(None)
            except IOError as e:
                errors.append(str(e))
        assert errors[0] == errors[1]
        return errors[0]

    def tear(self, sid, logical, layer, kv) -> tuple:
        """Flip one payload byte of a host entry in both caches; returns
        what restores it."""
        saved = []
        for c in (self.t, self.j):
            h = c.seqs[sid].table[logical][1][layer][kv]
            q, s, crc = c.host.get(layer, h)
            torn = np.array(q)
            torn[1, 3] ^= 0x20
            c.host.pages[(layer, h)] = (torn, s, crc)
            saved.append((c, (layer, h), (q, s, crc)))
        return saved

    def assert_same(self) -> None:
        t, j = self.t, self.j
        assert list(t._free) == list(j._free)
        assert ({k: t.metrics.count.get(k, 0) for k in COUNTERS}
                == {k: j.metrics.count.get(k, 0) for k in COUNTERS})
        assert t.host.pages.keys() == j.host.pages.keys()
        for key, (q, s, crc) in t.host.pages.items():
            jq, js, jcrc = j.host.pages[key]
            assert np.array_equal(q, np.asarray(jq))
            assert np.array_equal(s, np.asarray(js))
            assert crc == int(jcrc)
        assert t.seqs.keys() == j.seqs.keys()
        for sid, seq in t.seqs.items():
            jt = j.seqs[sid].table
            assert [e[0] for e in seq.table] == [e[0] for e in jt]
            for et, ej in zip(seq.table, jt):
                if et[0] == "hbm":
                    assert et[1] == ej[1]
                    for li in range(SHAPE["n_layers"]):
                        for tp, jp in ((t.k_pool, j.k_pool),
                                       (t.v_pool, j.v_pool)):
                            assert np.array_equal(tp[li][et[1]].numpy(),
                                                  np.asarray(jp[li][ej[1]]))
                elif et[0] == "host":
                    assert et[1] == ej[1]
                    assert t._pack_page(et[1]) == j._pack_page(ej[1])
                else:
                    for kv in ("k", "v"):
                        assert np.array_equal(et[1][kv], ej[1][kv])


@pytest.fixture
def twins(monkeypatch):
    monkeypatch.setattr(jkv, "gather_quantize_crc", _oracle_gather)
    monkeypatch.setattr(jkv, "scatter_dequantize_crc", _oracle_scatter)
    return _Twins


@pytest.mark.parametrize("scenario", ["page-out", "round-trip", "torn",
                                      "torn-before-fresh", "stall",
                                      "fresh-first"])
def test_transit_end_state_equals_the_reference_loop(twins, scenario):
    L = SHAPE["n_layers"]
    if scenario in ("page-out", "round-trip", "torn"):
        tw = twins()
        other = tw.new()
        tw.fill(other, 5)                  # 2 pages, so the ids interleave
        sid = tw.new()
        tw.fill(sid, 10)                   # 3 pages, the last partial
        tw.both("deactivate", sid)
        tw.assert_same()
        assert tw.t.metrics.count["fused_kernel_passes"] == 3 * 2 * L
        if scenario == "torn":             # layer 1 of page 2 of 3
            saved = tw.tear(sid, 2, 1, 0)
            assert "layer 1 page 2" in tw.both("activate", sid)
            tw.assert_same()
            assert tw.t.metrics.count["transit_crc_errors"] == 1
            assert [e[0] for e in tw.t.seqs[sid].table] == \
                ["hbm", "hbm", "host"]
            # the reference bumps before it checks: pages 0-1 whole, and
            # page 2 up to the torn layer
            assert tw.t.metrics.count["fused_kernel_passes"] == \
                3 * 2 * L + 2 * 2 * L + 2 * 2
            for c, key, entry in saved:
                c.host.pages[key] = entry
        if scenario != "page-out":
            assert tw.both("activate", sid) is None
            tw.assert_same()
            assert tw.t.metrics.count.get("transit_crc_errors", 0) == \
                (scenario == "torn")
    elif scenario == "torn-before-fresh":  # [host, host, host (torn), fresh]
        tw = twins(n_pages=4)
        a = tw.new()
        tw.fill(a, 4)
        sid = tw.new()
        tw.fill(sid, 16)                   # 3 device pages, then bypass
        tw.both("deactivate", sid)
        tw.both("release", a)
        assert [e[0] for e in tw.t.seqs[sid].table] == \
            ["host", "host", "host", "host-fresh"]
        saved = tw.tear(sid, 2, 1, 1)
        assert "layer 1 page 2" in tw.both("activate", sid)
        tw.assert_same()
        assert tw.t.free_pages() == 2
        for c, key, entry in saved:
            c.host.pages[key] = entry
        assert tw.both("activate", sid) is None
        tw.assert_same()
    elif scenario == "stall":              # one free page too few
        tw = twins(n_pages=4)
        sid = tw.new()
        tw.fill(sid, 16)                   # 4 pages
        tw.both("deactivate", sid)
        other = tw.new()
        tw.fill(other, 2)                  # takes 1 of the 4 pages
        tw.both("activate", sid)
        tw.assert_same()
        assert tw.t.metrics.count["activate_stalls"] == 1
        assert tw.t.metrics.count["pages_in"] == 3
        assert [e[0] for e in tw.t.seqs[sid].table] == \
            ["hbm", "hbm", "hbm", "host"]
        tw.both("release", other)
        tw.both("activate", sid)
        tw.assert_same()
        assert tw.t.metrics.count["activate_stalls"] == 1
    else:                                  # fresh-first: [fresh, host]
        tw = twins(n_pages=2)
        a = tw.new()
        tw.fill(a, 8)                      # the whole pool
        sid = tw.new()
        tw.fill(sid, 4)                    # page 0 bypasses
        tw.both("deactivate", a)
        tw.fill(sid, 4)                    # page 1 on the device
        tw.both("deactivate", sid)
        assert [e[0] for e in tw.t.seqs[sid].table] == ["host-fresh", "host"]
        tw.assert_same()
        tw.both("activate", sid)
        tw.assert_same()
        assert tw.t.metrics.count["pages_in"] == 2
