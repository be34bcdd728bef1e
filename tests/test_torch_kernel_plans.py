"""The arithmetic of the port's redesigned attention kernels, on the CPU.

The CUDA kernels run only on the card; what they compute differently from
their plain versions is held here against the JAX oracles
``repro.kernels.ref`` on numpy inputs made from a seed:

- paged decode attention split over pages (flash-decoding): a plain twin of
  the partition and combine kernels, at 2e-5 in f32;
- flash attention on the tensor cores: a plain twin that rounds P to bf16
  before P V, as the kernel's register A operand does, at 2e-2 in bf16;
- the wrappers' host-side choices: the route by dtype and head width, the
  padded head width in shared memory, and the split plan.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as _jref
from repro_torch.kernels.flash_attention import (flash_attention_plain,
                                                 flash_route, padded_hd)
from repro_torch.kernels.paged_attention import (MAX_PPS, MAX_REP, N_SM,
                                                 _smem_bytes, split_plan)

NEG_INF = -1e30          # the kernels' masked score, finite
LOG2E = math.log2(math.e)
BN = 128                 # the tensor-core kernel's K/V tile

jpaged = jax.jit(_jref.paged_attention_ref)
jflash = jax.jit(_jref.flash_attention_ref,
                 static_argnames=("causal", "window"))


# ------------------------------------------------- paged: split / combine
def split_combine(q, k_pool, v_pool, table, lens, n_split):
    """csrc/paged_attention.cu's two kernels in plain PyTorch: split s of
    row b takes table entries [s * pps, (s + 1) * pps) clipped to
    ceil(len / page); each split's (m, l, acc) in the log2 domain; the
    combine weighs the splits that hold tokens by exp2(m_s - max m)."""
    B, H, hd = q.shape
    _, page, Hkv, _ = k_pool.shape
    n_rep, max_pages = H // Hkv, table.shape[1]
    pps = -(-max_pages // n_split)
    qs = q.float() * (LOG2E / math.sqrt(hd))
    out = torch.zeros((B, H, hd))
    for b in range(B):
        n = int(lens[b])
        n_pages = min(-(-n // page), max_pages)
        m = torch.full((n_split, H), NEG_INF)
        l = torch.zeros((n_split, H))
        acc = torch.zeros((n_split, H, hd))
        for s in range(n_split):
            t_lo = s * pps * page
            t_hi = min(min((s + 1) * pps, n_pages) * page, n)
            if t_lo >= t_hi:          # wholly past the length
                continue
            tok = torch.arange(t_lo, t_hi)
            pg = table[b, tok // page].long()
            kk = k_pool[pg, tok % page].float().repeat_interleave(n_rep, 1)
            vv = v_pool[pg, tok % page].float().repeat_interleave(n_rep, 1)
            sc = torch.einsum("hd,nhd->hn", qs[b], kk)
            m[s] = sc.max(dim=1).values
            p = torch.exp2(sc - m[s][:, None])
            l[s] = p.sum(dim=1)
            acc[s] = torch.einsum("hn,nhd->hd", p, vv)
        used = -(-n_pages // pps)      # the combine reads only these
        mx = m[:used].max(dim=0).values if used else torch.full((H,), NEG_INF)
        w = torch.exp2(m[:used] - mx)
        num = (w[..., None] * acc[:used]).sum(dim=0)
        den = (w * l[:used]).sum(dim=0)
        out[b] = num / torch.clamp(den, min=1e-30)[:, None]
    return out.to(q.dtype)


def paged_inputs(B, H, Hkv, hd, P, page, maxp, lens, seed):
    """Pools with poison past every length, a table of distinct pages."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    table = rng.permutation(P)[:B * maxp].reshape(B, maxp).astype(np.int32)
    for b, n in enumerate(lens):
        for pi in range(maxp):
            for off in range(page):
                if pi * page + off >= n:
                    k[table[b, pi], off] = 99.0
                    v[table[b, pi], off] = -99.0
    return q, k, v, table, np.asarray(lens, np.int32)


PAGED_SHAPES = {  # (B, H, Hkv, hd, P, page, maxp, lens)
    # len 0, a length on a page boundary (32 = 8 pages), ragged lengths
    "gqa": (4, 8, 2, 32, 64, 4, 16, [0, 32, 13, 61]),
    # MHA as phi3-mini-3.8b, lengths filling the table or one token
    "mha": (3, 4, 4, 16, 24, 8, 6, [48, 1, 17]),
}


@pytest.mark.parametrize("n_split", [1, 2, 3, 16])
@pytest.mark.parametrize("shape", sorted(PAGED_SHAPES))
def test_split_combine_twin_matches_jax_ref(shape, n_split):
    B, H, Hkv, hd, P, page, maxp, lens = PAGED_SHAPES[shape]
    q, k, v, table, sl = paged_inputs(B, H, Hkv, hd, P, page, maxp, lens,
                                      seed=n_split)
    got = split_combine(*(torch.tensor(a) for a in (q, k, v, table, sl)),
                        n_split=n_split)
    exp = np.asarray(jpaged(q, k, v, table, sl))
    np.testing.assert_allclose(got.numpy(), exp, atol=2e-5, rtol=2e-5)
    if 0 in lens:
        assert not got[lens.index(0)].any()    # len 0 gives zeros


def test_split_combine_twin_at_the_long_prompt_plan():
    """The long-prompt shape's table width (256 pages of 16) and lengths
    (1004, 4004 tokens) under the plan the wrapper picks, at a cut of the
    heads (2:1 of hd 128 instead of 16:2) and of the pool to what the
    two sequences use."""
    lens = [1004, 4004]
    pps, n_split = split_plan(2, 2, 256)
    q, k, v, table, sl = paged_inputs(2, 2, 1, 128, 512, 16, 256, lens,
                                      seed=7)
    got = split_combine(*(torch.tensor(a) for a in (q, k, v, table, sl)),
                        n_split=n_split)
    exp = np.asarray(jpaged(q, k, v, table, sl))
    np.testing.assert_allclose(got.numpy(), exp, atol=2e-5, rtol=2e-5)


# --------------------------------------------- flash: P rounded to bf16
def flash_tc_twin(q, k, v, *, causal, window):
    """csrc/flash_attention_sm90.cu in plain PyTorch: key tiles of 128, the
    online softmax in f32 in the log2 domain, P rounded to bf16 before
    P V (f32 sums), O / max(l, 1e-30)."""
    B, T, H, hd = q.shape
    S, n_rep = k.shape[1], H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)
    kf = k.float().repeat_interleave(n_rep, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(n_rep, 2).permute(0, 2, 1, 3)
    m = torch.full((B, H, T), NEG_INF)
    l = torch.zeros((B, H, T))
    o = torch.zeros((B, H, T, hd))
    qp = torch.arange(T)[:, None]
    for k0 in range(0, S, BN):
        kp = torch.arange(k0, min(k0 + BN, S))[None]
        s = qf @ kf[:, :, k0:k0 + BN].transpose(-1, -2) \
            * (LOG2E / math.sqrt(hd))
        ok = torch.ones((T, kp.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= qp - kp < window
        s = torch.where(ok, s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        corr = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[..., None]),
                        torch.zeros(()))
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] \
            + p.to(torch.bfloat16).float() @ vf[:, :, k0:k0 + BN]
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(torch.bfloat16)


@pytest.mark.parametrize("B,T,S,H,Hkv,hd,causal,window", [
    # qwen2.5-3b's 4000-token prefill at hd 128, cut from 16:2 heads to
    # 2:1 (heads are independent; the error grows with T, not H)
    (1, 4000, 4000, 2, 1, 128, True, 0),
    (1, 1000, 1000, 4, 4, 96, True, 0),     # phi3-mini-3.8b's hd
    (1, 300, 300, 4, 2, 16, True, 0),       # SMOKE's hd
    (1, 300, 257, 4, 2, 64, True, 32),      # ragged, sliding window
    (2, 300, 257, 2, 1, 64, False, 32),     # rows with no key -> 0
])
def test_flash_bf16_p_twin_matches_jax_ref(B, T, S, H, Hkv, hd, causal,
                                           window):
    rng = np.random.default_rng(T + hd)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    q, k, v = (torch.tensor(a).to(torch.bfloat16) for a in arrs)
    got = flash_tc_twin(q, k, v, causal=causal, window=window)
    exp = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                 causal=causal, window=window)
    exp = np.asarray(exp.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), exp, atol=2e-2,
                               rtol=2e-2)
    # each output row as a whole, as chip_smoke holds the kernel (ROW_TOL)
    d = np.linalg.norm(got.float().numpy() - exp, axis=-1)
    assert (d <= 1e-2 * np.linalg.norm(exp, axis=-1)).all()


def rows_rel_err(got, exp):
    """The largest ||got - exp|| / ||exp|| over the output rows."""
    d = (got.float() - exp.float()).norm(dim=-1)
    return float((d / exp.float().norm(dim=-1).clamp(min=1e-30)).max())


@pytest.mark.parametrize("T,H,Hkv,hd", [(4000, 2, 1, 128), (1000, 4, 4, 96)])
def test_row_tolerance_separates_a_dropped_key_tile(T, H, Hkv, hd):
    """chip_smoke's row check in bf16 (ROW_TOL 1e-2) passes the P-in-bf16
    twin and fails a kernel that skips one 128-key tile for the last 128
    query rows of a long causal prefill."""
    rng = np.random.default_rng(T + hd)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(torch.bfloat16)
               for s in ((1, T, H, hd), (1, T, Hkv, hd), (1, T, Hkv, hd)))
    exp = flash_attention_plain(q, k, v, causal=True)
    assert rows_rel_err(flash_tc_twin(q, k, v, causal=True, window=0),
                        exp) <= 1e-2
    # the faulty kernel: causal, but keys [lo, lo + 128) unseen by the
    # last 128 rows
    n_rep, lo = H // Hkv, (T // 2) // BN * BN
    s = torch.einsum("bthd,bshd->bhts", q.float(),
                     k.float().repeat_interleave(n_rep, 2)) / math.sqrt(hd)
    pos = torch.arange(T)
    valid = pos[None, :] <= pos[:, None]
    valid[T - BN:, lo:lo + BN] = False
    p = torch.softmax(s.masked_fill(~valid, -math.inf), dim=-1)
    bad = torch.einsum("bhts,bshd->bthd", p,
                       v.float().repeat_interleave(n_rep, 2))
    assert rows_rel_err(bad.to(torch.bfloat16), exp) > 0.07


# ----------------------------------------------------- host-side choices
@pytest.mark.parametrize("dtype,hd,S,route", [
    (torch.bfloat16, 128, 4000, "tc"),     # qwen2.5-3b
    (torch.bfloat16, 96, 128, "tc"),       # phi3-mini-3.8b
    (torch.bfloat16, 16, 12, "tc"),        # SMOKE configs
    (torch.bfloat16, 64, 1, "tc"),
    (torch.bfloat16, 20, 70, "simt"),      # TMA: strides of 16 bytes
    (torch.bfloat16, 128, 0, "simt"),      # no keys to map
    (torch.float32, 128, 128, "simt"),     # TF32 would miss 2e-5
    (torch.float32, 16, 12, "simt"),       # the SMOKE f32 parity
    (torch.bfloat16, 256, 2176, "tc"),     # recurrentgemma-9b
    (torch.float32, 256, 2176, "simt"),
])
def test_flash_route(dtype, hd, S, route):
    assert flash_route(dtype, hd, S) == route


@pytest.mark.parametrize("hd,hdp", [(16, 64), (64, 64), (96, 128),
                                    (128, 128), (160, 256), (256, 256)])
def test_flash_padded_head_width(hd, hdp):
    assert padded_hd(hd) == hdp


@pytest.mark.parametrize("B,Hkv,max_pages,plan,blocks", [
    (4, 2, 16, (1, 16), 128),      # qwen serve: the table allows 128 blocks
    (4, 32, 16, (4, 4), 512),      # phi3 serve
    (2, 2, 256, (2, 128), 512),    # qwen long prompts
    (2, 2, 2, (1, 2), 8),          # hybrid path at SMOKE size
    (64, 8, 4096, (64, 64), 32768),  # wide batch: the 64-page cap
])
def test_split_plan_at_the_served_shapes(B, Hkv, max_pages, plan, blocks):
    assert split_plan(B, Hkv, max_pages) == plan
    assert B * Hkv * plan[1] == blocks


@settings(max_examples=200, deadline=None, database=None)
@given(B=st.integers(1, 64), Hkv=st.integers(1, 64),
       max_pages=st.integers(1, 4096))
def test_split_plan_properties(B, Hkv, max_pages):
    """A power of two of pages a split, at most 64; the splits cover the
    table, none starts past it; 2 x 132 blocks whenever single pages would
    give them; twice the pages a split (within the cap) would fall short
    of that."""
    pps, n_split = split_plan(B, Hkv, max_pages)
    assert 1 <= pps <= MAX_PPS and pps & (pps - 1) == 0
    assert (n_split - 1) * pps < max_pages <= n_split * pps
    if B * Hkv * max_pages >= 2 * N_SM:
        assert B * Hkv * n_split >= 2 * N_SM
    if 2 * pps <= min(max_pages, MAX_PPS):
        assert B * Hkv * -(-max_pages // (2 * pps)) < 2 * N_SM


@pytest.mark.parametrize("B,n_rep,Hkv,hd,max_pages", [
    (4, 8, 2, 128, 16),      # qwen2.5-3b serve
    (2, 8, 2, 128, 256),     # qwen2.5-3b long prompts
    (4, 1, 32, 96, 16),      # phi3-mini-3.8b serve
    (2, 2, 2, 16, 4),        # SMOKE
])
def test_paged_shared_memory_fits_the_served_shapes(B, n_rep, Hkv, hd,
                                                    max_pages):
    """One block's 48 KB hold the merge area and the split's table
    entries at the plan and with one split over the whole table (the
    card tests' forced maximum)."""
    for pps in (split_plan(B, Hkv, max_pages)[0], max_pages):
        assert _smem_bytes(n_rep, hd, pps) <= 48 * 1024
    assert n_rep <= MAX_REP
