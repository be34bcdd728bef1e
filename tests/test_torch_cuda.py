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
    (2, 56, 8, 128, 16, 32, 9),    # deepseek-coder-33b decode: n_rep 7
    (2, 7, 1, 8, 16, 16, 4),       # deepseek SMOKE: n_rep 7, hd 8
    (2, 8, 1, 256, 16, 260, 128),  # recurrentgemma-9b ring: hd 256, 2048
])                                 # slots, n_rep 16 as two rows of 8
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
    (1, 300, 300, 4, 1, 256, True, 128),   # recurrentgemma-9b: hd 256
    (1, 100, 100, 2, 1, 160, True, 0),     # hd 160
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
    (1, 128, 128, 56, 8, 128, True, 0),    # deepseek-coder-33b: n_rep 7
    (1, 128, 128, 7, 1, 8, True, 0),       # deepseek SMOKE: hd 8, n_rep 7
    (1, 2176, 2176, 16, 1, 256, True, 2048),   # recurrentgemma-9b prefill
    (1, 200, 200, 4, 2, 256, True, 0),     # hd 256 / 160
    (1, 300, 257, 4, 2, 160, True, 0),
    (2, 384, 128, 4, 4, 256, False, 0),
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
    q = torch.zeros((1, 2, 272), device=card)
    pool = torch.zeros((2, 4, 2, 272), device=card)
    with pytest.raises(ValueError, match="hd 272"):
        paged_attention_cuda(q, pool, pool, table, lens)
    q = torch.zeros((1, 2, 16), device=card)
    pool = torch.zeros((2, 4, 2, 16), device=card)
    with pytest.raises(ValueError, match="pages_per_split 2"):
        paged_attention_cuda(q, pool, pool, table, lens, pages_per_split=2)


def test_flash_attention_refuses_what_the_kernel_does_not_take(card):
    q, k, v = _qkv(card, 1, 8, 8, 2, 2, 320, torch.float32)
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


class _Blocker:
    """A pool participant whose one item holds the pool's only worker
    until ``gate`` is set, so that the items submitted meanwhile reach
    the worker as one batch."""

    def __init__(self, gate) -> None:
        self.gate = gate

    def _evict_slot(self, item) -> None:
        self.gate.wait(timeout=10)

    def _complete_eviction(self) -> None:
        pass


def test_pool_page_out_from_a_worker_is_the_synchronous_one(card):
    """Two sequences' page-outs queued on a 1-worker pool reach the worker
    as one batch of 5 items: one codec launch from the worker's thread,
    and host entries bit-identical to the synchronous page-outs'."""
    import threading

    from repro_torch.core.metrics import Metrics
    from repro_torch.serve import PagedCacheConfig, PagedKVCache
    from repro_torch.volume.evict_pool import SharedEvictionPool
    rng = np.random.default_rng(9)
    kv = rng.standard_normal((20, 2, 2, 2, 128)).astype(np.float32) * 3
    pool = SharedEvictionPool(1, name="test", batch_max=8)
    try:
        caches = []
        for evict_pool in (pool, None):
            c = PagedKVCache(PagedCacheConfig(
                n_layers=2, n_kv_heads=2, head_dim=128, page_size=4,
                n_pages=16, max_pages_per_seq=8, dtype=torch.bfloat16),
                metrics=Metrics(), evict_pool=evict_pool, device=card)
            for n in (12, 8):                      # 3 pages, then 2
                sid = c.new_sequence()
                for t in range(n):
                    c.append_token(sid, [torch.tensor(x, device=card)
                                         for x in kv[t, 0]],
                                   [torch.tensor(x, device=card)
                                    for x in kv[t, 1]])
            caches.append(c)
        pooled, sync = caches
        gate = threading.Event()
        blocker = _Blocker(gate)
        pool.register(blocker)
        pool.submit(blocker, None)                 # the worker waits
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        for sid in (0, 1):
            pooled.deactivate(sid)
        assert _build.launch_counts().get("gather_quantize_crc", 0) == 0
        gate.set()
        assert pooled.drain_evictions(timeout=10)
        assert _build.launch_counts()["gather_quantize_crc"] == 1
        assert pooled.metrics.count["evict_batches"] == 1
        for sid in (0, 1):
            sync.deactivate(sid)
        assert _build.launch_counts()["gather_quantize_crc"] == 3
        for key in ("pages_out", "fused_kernel_passes", "fused_kernel_bytes"):
            assert pooled.metrics.count[key] == sync.metrics.count[key]
        assert pooled.host.pages.keys() == sync.host.pages.keys()
        for key, (q, s, crc) in pooled.host.pages.items():
            q2, s2, crc2 = sync.host.pages[key]
            assert np.array_equal(q, q2) and np.array_equal(s, s2)
            assert crc == crc2 == zlib.adler32(q.tobytes())
        assert sorted(pooled._free) == sorted(sync._free) == list(range(16))
    finally:
        pool.close()


def test_engine_over_a_pool_equal_on_cuda_and_cpu(card):
    """SMOKE f32 (TF32 off) in the engine's order over a cache with a
    4-worker eviction pool, requests suspended every 3 ticks: the greedy
    tokens and the cache's counters are the same on the card and the
    CPU, and nothing is left behind."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve import (PagedCacheConfig, PagedKVCache, PagedLM,
                                   ServeEngine)
    from repro_torch.volume.evict_pool import SharedEvictionPool
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-coder-33b", smoke=True, dtype=torch.float32)
    params = init_lm(cfg, torch.Generator().manual_seed(0))
    # pages_out is left out: whether a retiring request's queued page-out
    # runs before its release skips it is up to the workers' timing
    keys = ("pages_in", "suspends", "resumes", "transit_crc_errors",
            "bypass_pages")
    got = {}
    for dev in ("cuda", "cpu"):
        pool = SharedEvictionPool(4, name="test")
        try:
            cc = PagedCacheConfig(n_layers=cfg.n_layers,
                                  n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                                  page_size=4, n_pages=64,
                                  max_pages_per_seq=16, dtype=cfg.dtype)
            p = _to(params, dev)
            eng = ServeEngine(cfg, p, cache_cfg=cc, max_batch=2, device=dev)
            eng.cache = PagedKVCache(cc, metrics=eng.metrics, evict_pool=pool,
                                     device=dev)
            eng.lm = PagedLM(cfg, p, eng.cache)
            rng = np.random.default_rng(2)
            reqs = [eng.submit(rng.integers(2, cfg.vocab, size=n).tolist(),
                               max_new_tokens=7) for n in (9, 14, 6, 11)]
            ticks = 0
            while eng.queue or eng.running or eng.suspended:
                eng.step()
                ticks += 1
                if eng.running and ticks % 3 == 0:
                    eng.suspend(eng.running[0])
            assert eng.cache.drain_evictions(timeout=10)
        finally:
            pool.close()
        count = eng.metrics.count
        got[dev] = ([r.out_tokens for r in reqs],
                    {k: count.get(k, 0) for k in keys})
        assert len(eng.cache._free) == len(set(eng.cache._free)) == 64
        assert len(eng.cache.host) == 0
    assert got["cuda"] == got["cpu"]
    assert got["cuda"][1]["suspends"] > 0 and got["cuda"][1]["pages_in"] > 0


def test_planned_steps_on_the_card_equal_token_writes(card):
    """The decode-step plan on the card (slots, table and lengths uploaded
    from pinned buffers without a wait, one indexed copy a layer) leaves
    the bf16 pools bit for bit and the free list as the per-token writes
    leave them, and attends alike, at phi3-mini's KV width, over steps
    that open pages."""
    from repro_torch.serve import PagedCacheConfig, PagedKVCache
    L, H, hd = 4, 32, 96
    cc = PagedCacheConfig(n_layers=L, n_kv_heads=H, head_dim=hd,
                          page_size=16, n_pages=64, max_pages_per_seq=8)
    planned, tokens = caches = [PagedKVCache(cc, device=card)
                                for _ in range(2)]
    g = torch.Generator(device=card).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, device=card, generator=g).to(cc.dtype)
    batch = []
    for n in (15, 16, 1, 40, 7):
        k, v = randn(L, n, H, hd), randn(L, n, H, hd)
        sids = {c.new_sequence() for c in caches}
        for c in caches:
            c.append_tokens(*sids, list(k), list(v))
        batch.append(sids.pop())
    B, none = len(batch), [None] * (L - 1)
    for _ in range(20):
        plan = planned.plan_step(batch)
        assert plan is not None
        for li in range(L):
            k, v, q = randn(B, H, hd), randn(B, H, hd), randn(B, H, hd)
            planned.write_step(plan, li, k[:, None], v[:, None])
            for bi, sid in enumerate(batch):
                if li == 0:
                    tokens.append_token(sid, [k[bi]] + none, [v[bi]] + none)
                else:
                    tokens.overwrite_token(sid, li, (k[bi], v[bi]))
            assert torch.equal(planned.plan_attention(plan, li, q),
                               tokens.attention(li, q, batch))
    assert torch.equal(planned._kv.view(torch.uint8),
                       tokens._kv.view(torch.uint8))
    assert planned._free == tokens._free
    assert planned.metrics.count["decode_plan_steps"] == 20


# --------------------------------------------------- the model API's shapes
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,Hkv,hd", [
    (2, 64, 1500, 20, 20, 64),             # whisper cross-attention
    (2, 128, 1600, 32, 8, 128),            # llama-3.2-vision cross-attention
])
def test_flash_attention_non_causal_t_ne_s(card, B, T, S, H, Hkv, hd, dtype):
    """Cross-attention over frames or patches: non-causal, T != S."""
    q, k, v = _qkv(card, B, T, S, H, Hkv, hd, dtype, seed=7)
    got = flash_attention_cuda(q, k, v, causal=False)
    exp = flash_attention_plain(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert_rows_close(got, exp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Hkv,hd,lens", [
    (2, 1500, 20, 20, 64, [1500, 1499]),   # whisper cross: page 4
    (4, 136, 64, 4, 64, [136, 133, 129, 1]),    # qwen3-moe: n_rep 16, page 8
    (3, 144, 16, 16, 128, [144, 65, 2]),   # moonshot self: page 16
])
def test_decode_attention_over_a_contiguous_cache(card, B, S, H, Hkv, hd,
                                                  lens, dtype):
    """``layers.decode_attention`` launches the paged kernel once over the
    cache viewed as pages (n_rep 16 as two rows of 8), and agrees with the
    plain version at the full n_rep, poison past every length."""
    from repro_torch.models.layers import (contiguous_page, decode_attention,
                                           decode_pages)
    g = torch.Generator(device=card).manual_seed(8)
    q = torch.randn((B, 1, H, hd), generator=g, device=card).to(dtype)
    k = torch.randn((B, S, Hkv, hd), generator=g, device=card)
    v = torch.randn((B, S, Hkv, hd), generator=g, device=card)
    for b, n in enumerate(lens):
        k[b, n:], v[b, n:] = 99.0, -99.0
    k, v = k.to(dtype), v.to(dtype)
    n_lens = torch.tensor(lens, dtype=torch.int32, device=card)
    pages = decode_pages(n_lens, S, H // Hkv)
    assert pages.page == contiguous_page(S)
    before = _build.launch_counts().get("paged_attention", 0)
    got = decode_attention(q, k, v, pages)[:, 0]
    assert _build.launch_counts()["paged_attention"] == before + 1
    page = pages.page
    table = torch.arange(B * S // page, dtype=torch.int32,
                         device=card).view(B, -1)
    exp = paged_attention_plain(q[:, 0], k.view(-1, page, Hkv, hd),
                                v.view(-1, page, Hkv, hd), table, n_lens)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), exp.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert_rows_close(got, exp)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b",
                                  "qwen3-moe-235b-a22b", "whisper-large-v3",
                                  "llama-3.2-vision-11b"])
def test_model_api_equal_on_cuda_and_cpu(card, arch):
    """SMOKE f32 (TF32 off), every xgate 0.5: prefill and 8 greedy decode
    steps through ``build_model`` on the card and the CPU from the same
    weights: tokens equal, logits and the cache within ROW_TOL, and on
    the card one flash launch a prefill attention layer and one paged
    launch a decode attention layer."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True, dtype=torch.float32)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    for blk in (params.get("dec_blocks", [])
                + [g["cross"] for g in params.get("groups", [])]):
        blk["xgate"].fill_(0.5)
    rng = np.random.default_rng(3)
    B, T, steps = 2, 10, 8
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (B, T)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)), dtype=torch.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.as_tensor(rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)), dtype=torch.float32)
    n_attn = cfg.n_layers + {"encdec": cfg.n_layers,
                             "vlm": cfg.n_layers // max(cfg.cross_every, 1)
                             }.get(cfg.family, 0)
    n_flash = n_attn + (cfg.enc_layers if cfg.family == "encdec" else 0)
    got = {}
    for dev in ("cuda", "cpu"):
        p, b = _to(params, dev), _to(batch, dev)
        _build.reset_launch_counts()
        logits, cache = model.prefill(p, b, s_max=T + steps)
        out = [logits]
        for i in range(steps):
            logits, cache = model.decode_step(p, cache, out[-1].argmax(-1),
                                              np.full(B, T + i))
            out.append(logits)
        if dev == "cuda":
            torch.cuda.synchronize()
            n = _build.launch_counts()
            assert n.get("flash_attention", 0) == n_flash
            assert n.get("paged_attention", 0) == steps * n_attn
        got[dev] = ([o.cpu() for o in out], _to(cache, "cpu"))
    for a, c in zip(got["cuda"][0], got["cpu"][0]):
        assert torch.equal(a.argmax(-1), c.argmax(-1))
        d = (a - c).norm(dim=-1)
        assert (d <= ROW_TOL[torch.float32] * c.norm(dim=-1)).all()

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] \
            if isinstance(t, dict) else [t]
    for a, c in zip(leaves(got["cuda"][1]), leaves(got["cpu"][1])):
        if a.dtype == torch.int32:
            assert torch.equal(a, c)
        else:
            d = (a - c).norm(dim=-1)
            assert (d <= ROW_TOL[torch.float32] * c.norm(dim=-1)
                    + 1e-30).all()


# --------------------------------------------------------------- training
def _train_batch(cfg, B=4, T=32, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab, (B, T)).astype(np.int32),
            "targets": r.integers(0, cfg.vocab, (B, T)).astype(np.int32)}


def test_trainer_equal_on_cuda_and_cpu(card):
    """phi3 SMOKE in f32 (TF32 off), 4 ``Trainer`` steps from the same
    weights and data on the card and the CPU: losses within rtol 1e-4,
    parameters within ROW_TOL row by row, and on the card the SIMT flash
    kernel launched twice a layer and step (the forward, and its
    recompute under remat "dots")."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamW, tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("phi3-mini-3.8b", smoke=True, dtype=torch.float32)
    model = build_model(cfg)
    init = model.init(torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cuda", "cpu"):
        m = dataclasses.replace(model, init=lambda gen: _to(init, gen.device))
        tr = Trainer(m, AdamW(lr=1e-3, total_steps=100),
                     SyntheticLM(cfg.vocab, seq=32, global_batch=4),
                     cfg=TrainConfig(total_steps=4), device=dev)
        _build.reset_launch_counts()
        out[dev] = tr.run()
        if dev == "cuda":
            torch.cuda.synchronize()
            n = _build.launch_counts()
            assert n.get("flash_attention", 0) == 4 * 2 * cfg.n_layers
            assert n.get("flash_attention_tc", 0) == 0
    np.testing.assert_allclose(out["cuda"]["losses"], out["cpu"]["losses"],
                               rtol=1e-4)
    for a, c in zip(tree_leaves(out["cuda"]["params"]),
                    tree_leaves(out["cpu"]["params"])):
        a = a.detach().cpu().float().reshape(-1, a.shape[-1] if a.dim()
                                             else 1)
        c = c.detach().float().reshape(a.shape)
        d = (a - c).norm(dim=-1)
        assert (d <= ROW_TOL[torch.float32] * c.norm(dim=-1)).all()


def _phi3_bf16_grads(card, remat="dots"):
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.optim import tree_leaves
    cfg = get_config("phi3-mini-3.8b", smoke=True, remat=remat)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(0))
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    _build.reset_launch_counts()
    loss = model.loss(params, _train_batch(cfg))
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    return cfg, grads, dict(_build.launch_counts())


def test_bf16_training_gradient_on_the_tensor_core_route(card, monkeypatch):
    """phi3 SMOKE in bf16 (hd 16): the loss's gradient runs the
    tensor-core flash kernel twice a layer (the forward and its recompute
    under remat "dots") and is finite; and at each layer's own q, k and v
    the flash op's output and gradient (the kernel's forward, the plain
    version's recompute in the backward) equal the plain version's within
    the bf16 element and row tolerances."""
    from repro_torch.models import transformer
    inputs = []
    flash = transformer.flash_attention

    def recorded(q, k, v, causal=True, window=0):
        inputs.append(tuple(t.detach().clone() for t in (q, k, v)))
        return flash(q, k, v, causal=causal, window=window)
    monkeypatch.setattr(transformer, "flash_attention", recorded)
    cfg, grads, n = _phi3_bf16_grads(card)
    assert n.get("flash_attention_tc", 0) == n.get("flash_attention", 0) \
        == 2 * cfg.n_layers
    assert all(torch.isfinite(g).all() for g in grads)
    assert len(inputs) == 2 * cfg.n_layers     # the recompute's inputs too
    g = torch.Generator(device=card).manual_seed(1)
    for q, k, v in inputs[:cfg.n_layers]:
        assert q.dtype == torch.bfloat16 and q.shape[-1] == 16
        dout = torch.randn(q.shape, generator=g, device=card).to(q.dtype)
        got, exp = [], []
        for fn, res in ((ops.flash_attention, got),
                        (flash_attention_plain, exp)):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = fn(*leaves, causal=True, window=0)
            out.backward(dout)
            res += [out.detach()] + [t.grad for t in leaves]
        torch.cuda.synchronize()
        for a, e in zip(got, exp):
            torch.testing.assert_close(a.float(), e.float(),
                                       atol=TOL[torch.bfloat16],
                                       rtol=TOL[torch.bfloat16])
            assert_rows_close(a, e)


def test_remat_gradients_equal_with_the_kernel(card):
    """remat "none", "dots" and "full" give the same bf16 gradient on the
    card, bit for bit, with the tensor-core flash kernel in the loop; the
    recomputing modes launch it twice a layer, "none" once."""
    grads = {}
    for mode in ("none", "dots", "full"):
        cfg, grads[mode], n = _phi3_bf16_grads(card, remat=mode)
        assert n.get("flash_attention_tc", 0) == cfg.n_layers * (
            1 if mode == "none" else 2)
    for mode in ("dots", "full"):
        for a, b in zip(grads["none"], grads[mode]):
            assert torch.equal(a, b)


# ------------------------------------------------------------- checkpoints
def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_bf16_checkpoint_crosses_card_and_cpu(card, src, dst):
    """internlm2 SMOKE in its default dtype (bf16 weights, f32 norms and
    moments) saved from one device restores on the other bit for bit,
    through ``restore(like=..., device=)``, the Trainer's path."""
    from repro_torch.ckpt import CheckpointEngine, make_blockstore
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamW, tree_leaves
    cfg = get_config("internlm2-1.8b", smoke=True)
    params = build_model(cfg).init(torch.Generator(device=src).manual_seed(0))
    opt_state = AdamW().init(params)
    g = torch.Generator(device=src).manual_seed(1)
    for t in tree_leaves(opt_state)[1:]:
        t.copy_(torch.randn(t.shape, generator=g, device=src))
    state = {"params": params, "opt": opt_state}
    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20))
    eng.save(2, state)
    got, step = eng.restore(like=state, device=dst)
    eng.close()
    assert step == 2
    want = {k: _bits(t) for k, t in _paths(state)}
    have = dict(_paths(got))
    assert have.keys() == want.keys()
    for k, t in have.items():
        assert t.device.type == dst
        assert torch.equal(_bits(t), want[k]), k
    assert any(t.dtype == torch.bfloat16 for t in tree_leaves(got))


def _paths(tree, prefix=""):
    """(path, leaf) of a tree of dicts, lists and NamedTuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple):
        items = zip(tree._fields, tree)
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [p for k, v in items for p in _paths(v, f"{prefix}/{k}")]


def test_trainer_crash_restart_on_the_card(card):
    """internlm2 SMOKE (bf16) on the card with a checkpoint every 2 steps:
    step 5 raises (a crash) after the step-3 save; a new Trainer resumes
    at step 4 and its losses at steps 4-7 equal an uninterrupted run's
    within rtol 1e-4."""
    from repro_torch.ckpt import CheckpointEngine, make_blockstore
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.api import build_model
    from repro_torch.optim import AdamW, tree_leaves
    from repro_torch.train.loop import TrainConfig, Trainer
    cfg = get_config("internlm2-1.8b", smoke=True)
    model = build_model(cfg)
    src = SyntheticLM(cfg.vocab, seq=32, global_batch=4)

    def trainer(ckpt, steps, every):
        return Trainer(model, AdamW(lr=1e-3, total_steps=100), src,
                       ckpt=ckpt, cfg=TrainConfig(total_steps=steps,
                                                  ckpt_every=every))

    class Crash(RuntimeError):
        pass

    eng = CheckpointEngine(make_blockstore(capacity_bytes=64 << 20))
    tr = trainer(eng, 8, 2)
    step_fn = tr.step_fn

    def crashing(*a):
        if len(tr.history) == 5:
            raise Crash("step 5")
        return step_fn(*a)

    tr.step_fn = crashing
    with pytest.raises(Crash):
        tr.run()
    assert eng.latest_step() == 3
    out = trainer(eng, 8, 100).run()
    ref = trainer(None, 8, 100).run()
    eng.close()
    assert out["last_step"] == 7 and len(out["losses"]) == 4
    assert all(t.is_cuda for t in tree_leaves(out["params"]))
    np.testing.assert_allclose(out["losses"], ref["losses"][4:], rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,hd,page,P,maxp,lens", [
    (4, 16, 2, 128, 16, 64, 16, (200, 0, 1, 256)),   # qwen2.5-3b serving
    (4, 8, 8, 128, 16, 36, 9, (144, 130, 0, 17)),    # moonshot's 144 slots
    (2, 8, 1, 256, 16, 260, 128, (2048, 0)),         # the ring, hd 256
])
def test_paged_attention_lse_matches_plain(card, B, H, Hkv, hd, page, P,
                                           maxp, lens, dtype):
    """The combine launch's per-row log-sum-exp (the mesh's S-sharded
    decode merges shards by it), a row of length 0 included: lse -inf,
    output 0."""
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((B, H, hd), generator=g, device=card).to(dtype)
    kp = torch.randn((P, page, Hkv, hd), generator=g, device=card).to(dtype)
    vp = torch.randn((P, page, Hkv, hd), generator=g, device=card).to(dtype)
    table = torch.tensor(np.random.default_rng(0).permutation(P)[:B * maxp]
                         .reshape(B, maxp), dtype=torch.int32, device=card)
    lens = torch.tensor(lens, dtype=torch.int32, device=card)
    out, lse = paged_attention_cuda(q, kp, vp, table, lens, return_lse=True)
    exp_out, exp_lse = paged_attention_plain(q, kp, vp, table, lens,
                                             return_lse=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), exp_out.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    empty = lens == 0
    assert bool(torch.isneginf(lse[empty]).all())
    assert bool((out[empty] == 0).all())
    torch.testing.assert_close(lse[~empty], exp_lse[~empty], atol=1e-4,
                               rtol=1e-5)
    assert torch.equal(out, paged_attention_cuda(q, kp, vp, table, lens))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 100),
                                           (False, 0)])
@pytest.mark.parametrize("parts", [2, 4])
def test_flash_attention_q_offset_matches_plain(card, parts, causal, window,
                                                dtype):
    """deepseek-coder-33b's heads (56:8, hd 128) with the query rows split
    2 and 4 ways, each part at its ``q_offset``: every part equals the
    plain version at that offset and the rows of the whole prompt's
    kernel output; bf16 runs the tensor-core kernel, f32 the SIMT one."""
    B, T, H, Hkv, hd = 1, 512, 56, 8, 128
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((B, T, H, hd), generator=g, device=card).to(dtype)
    k = torch.randn((B, T, Hkv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((B, T, Hkv, hd), generator=g, device=card).to(dtype)
    whole = flash_attention_cuda(q, k, v, causal=causal, window=window)
    n = T // parts
    _build.reset_launch_counts()
    for i in range(parts):
        qi = q[:, i * n:(i + 1) * n].contiguous()
        got = flash_attention_cuda(qi, k, v, causal=causal, window=window,
                                   q_offset=i * n)
        exp = flash_attention_plain(qi, k, v, causal=causal, window=window,
                                    q_offset=i * n)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), exp.float(), atol=TOL[dtype],
                                   rtol=TOL[dtype])
        assert_rows_close(got, exp)
        torch.testing.assert_close(got, whole[:, i * n:(i + 1) * n],
                                   atol=TOL[dtype], rtol=TOL[dtype])
    tc = _build.launch_counts().get("flash_attention_tc", 0)
    assert tc == (parts if dtype == torch.bfloat16 else 0)


def test_decode_through_a_one_rank_nccl_mesh_equals_off_mesh(card, tmp_path):
    """internlm2 SMOKE in f32 on a world-size-1 NCCL mesh (data 1, model
    1): the decode's S-sharded branch (the paged kernel with its
    log-sum-exp, merged by an NCCL all-reduce) and the weights wrapped
    with no copy give the off-mesh logits."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.parallel import distribute_tree, make_ctx, param_spec_tree
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        cfg = get_config("internlm2-1.8b", smoke=True, dtype=torch.float32)
        model = build_model(cfg)
        p = model.init(torch.Generator(device=card).manual_seed(0))
        mesh = make_local_mesh(1)
        ctx = make_ctx(mesh, 2)
        pd = distribute_tree(p, param_spec_tree(p, mesh), mesh)
        assert pd["embed"].to_local().data_ptr() == p["embed"].data_ptr()
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
        a, ca = model.prefill(p, {"tokens": toks}, s_max=16)
        b, cb = model.prefill(pd, {"tokens": toks}, ctx=ctx, s_max=16)
        torch.testing.assert_close(b.full_tensor(), a, atol=2e-5, rtol=2e-5)
        _build.reset_launch_counts()
        for i in range(3):
            tok = a.argmax(-1)
            a, ca = model.decode_step(p, ca, tok, np.full(2, 12 + i))
            b, cb = model.decode_step(pd, cb, tok, np.full(2, 12 + i),
                                      ctx=ctx)
            torch.testing.assert_close(b.full_tensor(), a, atol=2e-5,
                                       rtol=2e-5)
        assert _build.launch_counts()["paged_attention"] == \
            2 * 3 * cfg.n_layers
        assert torch.equal(cb["pos"].full_tensor(), ca["pos"])
    finally:
        dist.destroy_process_group()


def test_moe_combine_is_deterministic_on_the_card(card, monkeypatch):
    """moonshot-v1-16b-a3b's MoE widths in bf16 (64 experts, top 6, a
    4 x 128 prefill): two calls give the same bits, and the combine
    agrees with the scatter-add of the same slots on the card."""
    import repro_torch.models.layers as tl
    D, E, F, k, T = 2048, 64, 1408, 6, 512
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn((T, D), generator=g, device=card).to(torch.bfloat16)
    router = torch.randn((D, E), generator=g, device=card) / D ** 0.5
    wg, wu = (torch.randn((E, D, F), generator=g, device=card
                          ).to(torch.bfloat16) / D ** 0.5 for _ in range(2))
    wd = torch.randn((E, F, D), generator=g, device=card
                     ).to(torch.bfloat16) / F ** 0.5
    kw = dict(top_k=k, capacity=tl.moe_capacity(T, k, E, 1.25))
    seen, combine = {}, tl.combine_top_k

    def spy(ye, idx, topi, T):
        seen.update(ye=ye, idx=idx)
        return combine(ye, idx, topi, T)
    monkeypatch.setattr(tl, "combine_top_k", spy)
    a = tl.moe_local(x, router, wg, wu, wd, **kw)
    b = tl.moe_local(x, router, wg, wu, wd, **kw)
    assert torch.equal(a, b)
    exp = torch.zeros_like(a).index_add_(0, seen["idx"].reshape(-1),
                                         seen["ye"].reshape(-1, D))
    assert_rows_close(a, exp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_fake_forms_match_the_kernels_and_cuda_still_launches(
        card, dtype):
    """The attention ops' fake forms (the dry run's path) give the real
    kernels' output shapes and dtypes on the card; real CUDA tensors still
    reach the kernels, whose launch counters move."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((2, 40, 8, 96), generator=g, device=card).to(dtype)
    k = torch.randn((2, 40, 2, 96), generator=g, device=card).to(dtype)
    v = torch.randn((2, 40, 2, 96), generator=g, device=card).to(dtype)
    pq = torch.randn((3, 8, 64), generator=g, device=card).to(dtype)
    kp = torch.randn((6, 16, 2, 64), generator=g, device=card).to(dtype)
    vp = torch.randn((6, 16, 2, 64), generator=g, device=card).to(dtype)
    table = torch.arange(6, dtype=torch.int32, device=card).view(3, 2)
    lens = torch.tensor([5, 32, 17], dtype=torch.int32, device=card)
    _build.reset_launch_counts()
    real = (ops.flash_attention(q, k, v, window=16),
            *ops.paged_attention(pq, kp, vp, table, lens, return_lse=True),
            ops.paged_attention(pq, kp, vp, table, lens))
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    assert counts.get("flash_attention", 0) == 1
    assert counts.get("paged_attention", 0) == 2
    with FakeTensorMode() as mode:
        fq, fk, fv, fpq, fkp, fvp, ft, fl = (
            mode.from_tensor(t) for t in (q, k, v, pq, kp, vp, table, lens))
        fake = (ops.flash_attention(fq, fk, fv, window=16),
                *ops.paged_attention(fpq, fkp, fvp, ft, fl, return_lse=True),
                ops.paged_attention(fpq, fkp, fvp, ft, fl))
    assert _build.launch_counts() == counts      # the fakes launch nothing
    for r, f in zip(real, fake):
        assert f.shape == r.shape and f.dtype == r.dtype
        assert f.device == r.device
