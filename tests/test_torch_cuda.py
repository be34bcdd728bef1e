"""The port's CUDA kernels against their plain versions on the card.

Marked ``cuda``: each test asks for the ``card`` fixture, which skips when
no GPU is present.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops
from repro_torch.kernels.block_transit import (gather_quantize_crc_plain,
                                               gather_quantize_cuda,
                                               scatter_dequantize_crc_plain,
                                               scatter_dequantize_cuda)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}   # chip_smoke's


def assert_rows_close(got, exp):
    """Each output row (last dimension) as a whole: ||got - exp|| <=
    ROW_TOL * ||exp||, which long rows of small elements need."""
    d = (got.float() - exp.float()).norm(dim=-1)
    assert (d <= ROW_TOL[exp.dtype] * exp.float().norm(dim=-1)).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run on the card only")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,hd,page,P,maxp", [
    (4, 16, 2, 128, 16, 64, 16),   # qwen2.5-3b decode
    (3, 4, 2, 16, 16, 16, 4),      # qwen2.5-3b SMOKE
    (2, 8, 1, 128, 16, 12, 3),     # n_rep 8
    (4, 32, 32, 96, 16, 64, 16),   # phi3-mini-3.8b decode: hd 96, n_rep 1
])
def test_paged_attention_kernel_matches_plain(card, B, H, Hkv, hd, page, P,
                                              maxp, dtype):
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((B, H, hd), generator=g, device=card).to(dtype)
    kp = torch.randn((P, page, Hkv, hd), generator=g, device=card).to(dtype)
    vp = torch.randn((P, page, Hkv, hd), generator=g, device=card).to(dtype)
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.permutation(P)[:B * maxp].reshape(B, maxp),
                         dtype=torch.int32, device=card)
    lens = torch.tensor(rng.integers(0, page * maxp + 1, B), dtype=torch.int32,
                        device=card)
    got = paged_attention_cuda(q, kp, vp, table, lens)
    exp = paged_attention_plain(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _units(card, rng, S, P, n):
    """2n distinct (slot, page) units in mixed order: n to read, n others
    to write."""
    idx = rng.permutation(S * P)[:2 * n]
    pairs = np.stack([idx // P, idx % P], 1).astype(np.int32)
    return (torch.tensor(pairs[:n], device=card),
            torch.tensor(pairs[n:], device=card))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,P,page,F,n", [
    (1, 64, 16, 256, 1),      # one unit
    (72, 3, 16, 256, 72),     # a qwen2.5-3b page: 36 layers x K/V
    (64, 3, 16, 3072, 64),    # a phi3-mini-3.8b page: 32 layers x K/V
    (1, 16, 8, 384, 4), (1, 16, 16, 32, 3), (1, 64, 16, 3072, 2)])
def test_transit_codec_kernels_bit_exact(card, S, P, page, F, n, dtype):
    """One launch over n units against the plain version bit for bit, the
    crcs against zlib; a flipped byte in unit k moves crc k only, and the
    restore leaves every unit it is not given untouched."""
    g = torch.Generator(device=card).manual_seed(1)
    stack = (torch.randn((S, P, page, F), generator=g, device=card)
             * 3).to(dtype)
    src, dst = _units(card, np.random.default_rng(1), S, P, n)
    q, s, c = gather_quantize_cuda(stack, src)
    qp, sp, cp = gather_quantize_crc_plain(stack, src)
    q2, s2 = gather_quantize_cuda(stack, src, with_crc=False)
    assert torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(c, cp)
    assert torch.equal(q2, qp) and torch.equal(s2, sp)
    qh = q.cpu().numpy()
    assert c.tolist() == [zlib.adler32(qh[i].tobytes()) for i in range(n)]
    pk, pp, p2 = stack.clone(), stack.clone(), stack.clone()
    _, rc = scatter_dequantize_cuda(pk, dst, q, s)
    _, rcp = scatter_dequantize_crc_plain(pp, dst, q, s)
    scatter_dequantize_cuda(p2, dst, q, s, with_crc=False)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(p2, pp)
    assert torch.equal(rc, c) and torch.equal(rcp, c)
    keep = torch.ones((S, P), dtype=torch.bool, device=card)
    keep[dst[:, 0].long(), dst[:, 1].long()] = False
    assert torch.equal(pk[keep], stack[keep])
    k = n // 2
    qc = q.clone()
    qc[k, page // 2, F // 3] ^= 1
    _, rc2 = scatter_dequantize_cuda(stack.clone(), dst, qc, s)
    torch.cuda.synchronize()
    moved = (rc2 != c).nonzero().flatten().tolist()
    assert moved == [k]


def test_ops_route_cuda_tensors_to_the_kernels(card):
    """The one-pool API and the batched one each launch the kernel once a
    call, whatever the number of units."""
    pool = torch.randn((8, 16, 64), device=card)
    ids = torch.tensor([3], dtype=torch.int32, device=card)
    before = _build.launch_counts()
    q, s, _ = ops.gather_quantize_crc(pool, ids)
    ops.scatter_dequantize_crc(pool, ids, q, s)
    after = _build.launch_counts()
    for name in ("gather_quantize_crc", "scatter_dequantize_crc"):
        assert after.get(name, 0) == before.get(name, 0) + 1
    stack = torch.randn((6, 8, 16, 64), device=card)
    units = torch.tensor([(sl, p) for p in (1, 5) for sl in range(6)],
                         dtype=torch.int32, device=card)
    q, s, _ = ops.gather_quantize_crc_units(stack, units)
    ops.scatter_dequantize_crc_units(stack, units, q, s)
    for name in ("gather_quantize_crc", "scatter_dequantize_crc"):
        assert _build.launch_counts()[name] == after[name] + 1


def test_one_codec_launch_per_page_out_and_page_in(card):
    """On a SMOKE engine with a suspend and a resume, every deactivate that
    pages out launches the spill kernel once, every activate that pages in
    launches the restore kernel once, and the cache counts the reference's
    2 passes per layer per page."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import PagedCacheConfig, ServeEngine
    cfg = get_config("qwen2.5-3b", smoke=True, dtype=torch.float32)
    params = init_lm(cfg, torch.Generator(device=card).manual_seed(0))
    eng = ServeEngine(cfg, params, max_batch=2, device=card,
                      cache_cfg=PagedCacheConfig(
                          n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.hd, page_size=8, n_pages=64,
                          max_pages_per_seq=16, dtype=cfg.dtype))
    moved = {"deactivate": 0, "activate": 0}
    count = eng.metrics.count
    for name, key in (("deactivate", "pages_out"), ("activate", "pages_in")):
        def call(sid, _fn=getattr(eng.cache, name), _name=name, _key=key):
            before = count.get(_key, 0)
            _fn(sid)
            moved[_name] += count.get(_key, 0) > before
        setattr(eng.cache, name, call)
    for n in (12, 20, 9):
        eng.submit(list(range(2, 2 + n)), max_new_tokens=6)
    _build.reset_launch_counts()
    eng.step()
    eng.step()
    eng.suspend(eng.running[0])
    eng.run()
    torch.cuda.synchronize()
    launched = _build.launch_counts()
    assert moved["deactivate"] == 4 and moved["activate"] == 1
    assert launched["gather_quantize_crc"] == moved["deactivate"]
    assert launched["scatter_dequantize_crc"] == moved["activate"]
    assert count["fused_kernel_passes"] == \
        2 * cfg.n_layers * (count["pages_out"] + count["pages_in"])
    assert eng.cache.free_pages() == 64 and len(eng.cache.host) == 0


def _qkv(card, B, T, S, H, Hkv, hd, dtype, seed=0):
    g = torch.Generator(device=card).manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device=card).to(dtype)
                 for shape in ((B, T, H, hd), (B, S, Hkv, hd),
                               (B, S, Hkv, hd)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Hkv,hd,causal,window", [
    (1, 128, 128, 2, 2, 64, True, 0),      # tests/test_kernels.py's sweep
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 8, 1, 128, True, 0),
    (2, 384, 128, 4, 4, 64, True, 0),
    (1, 256, 256, 2, 2, 64, True, 32),     # sliding windows
    (1, 256, 256, 2, 2, 64, True, 128),
    (1, 256, 256, 2, 2, 64, True, 500),
    (2, 128, 256, 2, 2, 64, False, 0),     # non-causal
    (1, 100, 100, 4, 2, 64, True, 0),      # ragged
    (1, 300, 257, 4, 2, 128, True, 0),
    (1, 12, 12, 4, 2, 16, True, 0),        # SMOKE prefill, hd 16
    (1, 128, 128, 32, 32, 96, True, 0),    # phi3-mini-3.8b prefill, hd 96
    (1, 300, 257, 2, 1, 64, False, 32),    # rows past every key -> 0
    (1, 70, 70, 2, 1, 20, True, 0),        # hd 20: scalar loads in bf16
])
def test_flash_attention_kernel_matches_plain(card, B, T, S, H, Hkv, hd,
                                              causal, window, dtype):
    q, k, v = _qkv(card, B, T, S, H, Hkv, hd, dtype)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    exp = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("B,T,S,H,Hkv,hd,causal,window", [
    (1, 128, 128, 16, 2, 128, True, 0),    # qwen2.5-3b prefill
    (1, 1000, 1000, 16, 2, 128, True, 0),
    (1, 128, 128, 32, 32, 96, True, 0),    # phi3-mini-3.8b prefill
    (1, 300, 257, 4, 2, 128, True, 0),     # ragged T and S
    (1, 256, 256, 2, 2, 64, True, 32),     # sliding window
    (1, 300, 257, 2, 1, 64, False, 32),    # non-causal, T > S: rows -> 0
    (2, 384, 128, 4, 4, 64, False, 0),
    (1, 200, 200, 4, 2, 16, True, 0),      # hd 16 / 64 / 96 / 128
    (1, 200, 200, 4, 2, 64, True, 0),
    (1, 200, 200, 4, 2, 96, True, 0),
    (1, 200, 200, 4, 2, 128, True, 0),
])
def test_flash_attention_tensor_core_kernel_matches_plain(
        card, B, T, S, H, Hkv, hd, causal, window):
    """bf16 with hd % 8 == 0 runs the wgmma kernel (one launch of it)."""
    q, k, v = _qkv(card, B, T, S, H, Hkv, hd, torch.bfloat16, seed=5)
    before = _build.launch_counts().get("flash_attention_tc", 0)
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    exp = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert _build.launch_counts()["flash_attention_tc"] == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), exp.float(), atol=2e-2,
                               rtol=2e-2)
    assert_rows_close(got, exp)


def test_flash_attention_routes(card):
    """f32 and bf16 with hd % 8 != 0 run the SIMT kernel, bf16 with
    hd % 8 == 0 the tensor-core one; each agrees with the plain version."""
    cases = [(_qkv(card, 1, 64, 64, 2, 1, 128, torch.float32), 0),
             (_qkv(card, 1, 64, 64, 2, 1, 20, torch.bfloat16), 0),
             (_qkv(card, 1, 64, 64, 2, 1, 64, torch.bfloat16), 1)]
    for (q, k, v), tc in cases:
        before = dict(_build.launch_counts())
        got = flash_attention_cuda(q, k, v)
        exp = flash_attention_plain(q, k, v)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        assert after["flash_attention"] == before.get("flash_attention", 0) + 1
        assert after.get("flash_attention_tc", 0) \
            == before.get("flash_attention_tc", 0) + tc
        torch.testing.assert_close(got.float(), exp.float(),
                                   atol=TOL[q.dtype], rtol=TOL[q.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pages_per_split", [None, 1, 256])
def test_paged_attention_split_at_the_long_prompt_shape(card, dtype,
                                                        pages_per_split):
    """The long-prompt path's decode: 1004 and 4004 tokens over a 256-wide
    table, poison past every length, under the wrapper's split plan, one
    page a split (the most splits) and one split; f32 as the hybrid path
    runs it."""
    B, H, Hkv, hd, page, P, maxp = 2, 16, 2, 128, 16, 512, 256
    lens = [1004, 4004]
    rng = np.random.default_rng(6)
    q = rng.standard_normal((B, H, hd))
    kp = rng.standard_normal((P, page, Hkv, hd))
    vp = rng.standard_normal((P, page, Hkv, hd))
    table = rng.permutation(P)[:B * maxp].reshape(B, maxp)
    for b, n in enumerate(lens):
        for pi in range(maxp):
            lo = max(n - pi * page, 0)
            kp[table[b, pi], lo:] = 99.0
            vp[table[b, pi], lo:] = -99.0
    args = [torch.tensor(a, device=card).to(dtype) for a in (q, kp, vp)] + [
        torch.tensor(table, dtype=torch.int32, device=card),
        torch.tensor(lens, dtype=torch.int32, device=card)]
    got = paged_attention_cuda(*args, pages_per_split=pages_per_split)
    exp = paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert_rows_close(got, exp)


def test_paged_attention_refuses_what_the_kernel_does_not_take(card):
    table = torch.zeros((1, 1), dtype=torch.int32, device=card)
    lens = torch.ones((1,), dtype=torch.int32, device=card)
    q = torch.zeros((1, 16, 16), device=card)
    pool = torch.zeros((2, 4, 1, 16), device=card)
    with pytest.raises(ValueError, match="n_rep 16"):
        paged_attention_cuda(q, pool, pool, table, lens)
    q = torch.zeros((1, 2, 160), device=card)
    pool = torch.zeros((2, 4, 2, 160), device=card)
    with pytest.raises(ValueError, match="hd 160"):
        paged_attention_cuda(q, pool, pool, table, lens)
    q = torch.zeros((1, 2, 16), device=card)
    pool = torch.zeros((2, 4, 2, 16), device=card)
    with pytest.raises(ValueError, match="pages_per_split 2"):
        paged_attention_cuda(q, pool, pool, table, lens, pages_per_split=2)


def test_flash_attention_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(card, 1, 8, 8, 2, 2, 192, torch.float32)
    with pytest.raises(ValueError, match="head width"):
        flash_attention_cuda(q, k, v)
    q, k, v = _qkv(card, 1, 8, 8, 2, 2, 64, torch.float32)
    with pytest.raises(TypeError, match="one dtype"):
        flash_attention_cuda(q, k.half(), v)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), k, v)


def test_flash_attention_gradient_on_the_card(card):
    """ops.flash_attention: forward on the kernel (one launch), backward
    by recompute through the plain version; both equal the plain op's."""
    q, k, v = _qkv(card, 2, 96, 96, 4, 2, 64, torch.float32, seed=3)
    dout = torch.randn_like(q)
    grads = []
    for fn in (ops.flash_attention, flash_attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = _build.launch_counts().get("flash_attention", 0)
        out = fn(*leaves, causal=True, window=40)
        out.backward(dout)
        launched = _build.launch_counts().get("flash_attention", 0) - before
        assert launched == (1 if fn is ops.flash_attention else 0)
        grads.append([out.detach()] + [t.grad for t in leaves])
    torch.cuda.synchronize()
    for got, exp in zip(*grads):
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, exp, atol=2e-5, rtol=2e-5)


def test_hybrid_attention_on_the_card_matches_the_plain_tiers(card):
    """A 2-page pool sends a sequence's later pages to the host tier; the
    hybrid path then runs the paged-attention kernel over the f32 view of
    every tier, and equals the same cache on the CPU (plain version)."""
    from repro_torch.core.metrics import Metrics
    from repro_torch.serve import PagedCacheConfig, PagedKVCache
    rng = np.random.default_rng(2)
    caches = {dev: PagedKVCache(PagedCacheConfig(
        n_layers=2, n_kv_heads=2, head_dim=16, page_size=4, n_pages=2,
        max_pages_per_seq=8, dtype=torch.float32), metrics=Metrics(),
        device=dev) for dev in ("cuda", "cpu")}
    sids = {dev: c.new_sequence() for dev, c in caches.items()}
    for _ in range(11):
        k = rng.standard_normal((2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 16)).astype(np.float32)
        for dev, c in caches.items():
            c.append_token(sids[dev], [torch.tensor(k, device=dev)] * 2,
                           [torch.tensor(v, device=dev)] * 2)
    q = rng.standard_normal((1, 4, 16)).astype(np.float32)
    before = _build.launch_counts().get("paged_attention", 0)
    got = caches["cuda"].attention(1, torch.tensor(q, device=card),
                                   [sids["cuda"]])
    exp = caches["cpu"].attention(1, torch.tensor(q), [sids["cpu"]])
    torch.cuda.synchronize()
    assert _build.launch_counts()["paged_attention"] == before + 1
    assert caches["cuda"].metrics.count["hybrid_attention"] == 1
    torch.testing.assert_close(got.cpu(), exp, atol=2e-5, rtol=2e-5)


def _pager_engine(dev, vol, cfg, params):
    """A SMOKE engine whose pool is so small that resuming two suspended
    requests at once stalls the second right after promoting a spilled
    page, with spilled pages behind it: decode then runs the hybrid path
    over ``vol`` pages."""
    from repro_torch.serve import KVPager, PagedCacheConfig, ServeEngine
    eng = ServeEngine(cfg, params, max_batch=2, device=dev,
                      pager=KVPager(vol, capacity_blocks=2048),
                      cache_cfg=PagedCacheConfig(
                          n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads,
                          head_dim=cfg.hd, page_size=4, n_pages=6,
                          host_pages=0, max_pages_per_seq=16,
                          dtype=cfg.dtype))
    vol_reads = []
    page_kv = eng.cache._page_kv

    def counted(layer, entry):
        vol_reads.append(entry[0] == "vol")
        return page_kv(layer, entry)
    eng.cache._page_kv = counted
    rng = np.random.default_rng(1)
    reqs = [eng.submit(rng.integers(2, cfg.vocab, size=n).tolist(),
                       max_new_tokens=8) for n in (8, 16, 9)]
    ticks = 0
    while eng.queue or eng.running or eng.suspended:
        eng.step()
        ticks += 1
        if ticks == 5:
            for r in list(eng.running):
                eng.suspend(r)
    return eng, [r.out_tokens for r in reqs], sum(vol_reads)


def test_engine_with_a_pager_equal_on_cuda_and_cpu(card):
    """SMOKE f32 (TF32 off) through the spill tier, a stalled resume and
    hybrid attention over spilled pages: the greedy tokens and every
    counter are the same on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.core.metrics import KV_PAGING_COUNTERS
    from repro_torch.models.transformer import init_lm
    from repro_torch.volume.volume import make_volume
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2.5-3b", smoke=True, dtype=torch.float32)
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    keys = (*KV_PAGING_COUNTERS, "pages_out", "pages_in", "activate_stalls",
            "transit_crc_errors", "fused_kernel_passes", "fused_kernel_bytes",
            "bypass_pages", "hybrid_attention", "suspends", "resumes")
    got = {}
    for dev in ("cuda", "cpu"):
        vol = make_volume(n_lbas=4096, n_shards=2, aio_workers=2,
                          cache_bytes=1 << 22)
        try:
            eng, tokens, vol_reads = _pager_engine(dev, vol, cfg,
                                                   _to(params, dev))
        finally:
            vol.close()
        count = eng.metrics.count
        got[dev] = (tokens, {k: count.get(k, 0) for k in keys}, vol_reads)
        assert eng.cache.free_pages() == 6 and len(eng.cache.host) == 0
        assert eng.cache.pager.stats()["records"] == 0
    assert got["cuda"] == got["cpu"]
    _, c, vol_reads = got["cuda"]
    assert c["kv_spills"] > 0 and c["kv_restores"] > 0
    assert c["activate_stalls"] > 0 and vol_reads > 0
    assert c["kv_restore_crc_errors"] == 0 and c["transit_crc_errors"] == 0


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _spilled_caches(vols, devices, host_pages):
    """One cache per device, each on its own pager and volume, holding the
    same 3-page sequence, deactivated: ``host_pages`` of them stay in the
    host tier and the others spill."""
    from repro_torch.core.metrics import Metrics
    from repro_torch.serve import KVPager, PagedCacheConfig, PagedKVCache
    from repro_torch.volume.volume import make_volume
    rng = np.random.default_rng(5)
    kv = rng.standard_normal((12, 2, 2, 2, 128)).astype(np.float32) * 4
    caches = {}
    for dev in devices:
        vols.append(make_volume(n_lbas=1024, n_shards=2, aio_workers=2,
                                cache_bytes=1 << 22))
        caches[dev] = c = PagedKVCache(PagedCacheConfig(
            n_layers=2, n_kv_heads=2, head_dim=128, page_size=4, n_pages=8,
            host_pages=host_pages, max_pages_per_seq=8,
            dtype=torch.bfloat16), metrics=Metrics(),
            pager=KVPager(vols[-1], capacity_blocks=512), device=dev)
        sid = c.new_sequence()
        for t in range(12):
            c.append_token(sid, [torch.tensor(x, device=dev)
                                 for x in kv[t, 0]],
                           [torch.tensor(x, device=dev) for x in kv[t, 1]])
        c.deactivate(sid)
    return caches


def test_spilled_page_restores_on_the_card_bit_exactly(card):
    """The same spilled records, restored through the pager into a cache
    on the card and into the same cache on the CPU: the pool pages are
    equal bit for bit, from a restore launch before the second record's
    fetch and one at the end."""
    vols = []
    try:
        caches = _spilled_caches(vols, ("cuda", "cpu"), host_pages=1)
        for c in caches.values():
            assert [e[0] for e in c.seqs[0].table] == ["vol", "vol", "host"]
        recs = [caches[d].pager.fetch(caches[d].seqs[0].table[0][1])
                for d in caches]
        assert recs[0] == recs[1]                  # the same record bytes
        _build.reset_launch_counts()
        caches["cuda"].activate(0)
        torch.cuda.synchronize()
        n = _build.launch_counts().get("scatter_dequantize_crc", 0)
        assert n == 2            # before the 2nd record's fetch, at the end
        caches["cpu"].activate(0)
        for c in caches.values():
            assert c.metrics.count.get("transit_crc_errors", 0) == 0
            assert c.metrics.count.get("kv_restore_crc_errors", 0) == 0
        for lg in range(3):
            pc = caches["cuda"].seqs[0].table[lg][1]
            pp = caches["cpu"].seqs[0].table[lg][1]
            for li in range(2):
                assert torch.equal(caches["cuda"].k_pool[li][pc].cpu(),
                                   caches["cpu"].k_pool[li][pp])
                assert torch.equal(caches["cuda"].v_pool[li][pc].cpu(),
                                   caches["cpu"].v_pool[li][pp])
    finally:
        for vol in vols:
            vol.close()


def test_one_restore_launch_without_volume_records(card):
    """With a pager attached but nothing spilled, a sequence's page-in is
    one restore launch, as without a pager."""
    vols = []
    try:
        c = _spilled_caches(vols, ("cuda",), host_pages=64)["cuda"]
        assert [e[0] for e in c.seqs[0].table] == ["host"] * 3
        _build.reset_launch_counts()
        c.activate(0)
        torch.cuda.synchronize()
        assert _build.launch_counts().get("scatter_dequantize_crc", 0) == 1
        assert [e[0] for e in c.seqs[0].table] == ["hbm"] * 3
        assert c.metrics.count.get("transit_crc_errors", 0) == 0
    finally:
        for vol in vols:
            vol.close()
