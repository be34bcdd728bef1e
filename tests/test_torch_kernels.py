"""The port's kernel functions on the CPU (their plain versions, through
``repro_torch.kernels.ops``) against the JAX oracles ``repro.kernels.ref``
and ``zlib.adler32``, on the same numpy inputs.  The shape sweeps are
``tests/test_kernels.py``'s.  Tolerances: attention 2e-5 in f32 and 2e-2
in bf16 (sums run in another order); q, scales and crcs bit-identical."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels import ref as _jref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.block_transit import (gather_quantize_cuda,
                                               scatter_dequantize_cuda)
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda


class jref:
    """The JAX oracles.  The attention ones are jit-compiled once per
    shape (op-by-op dispatch compiles every primitive anew and dominates
    these tests' time); the codec ones run eagerly, because under jit XLA
    turns ``amax / 127.0`` into a multiply by the reciprocal, a last-bit
    change of the scales, and the codec is held bit for bit to the
    division."""
    paged_attention_ref = staticmethod(jax.jit(_jref.paged_attention_ref))
    flash_attention_ref = staticmethod(jax.jit(
        _jref.flash_attention_ref, static_argnames=("causal", "window")))
    gather_quantize_ref = staticmethod(_jref.gather_quantize_ref)
    scatter_dequantize_ref = staticmethod(_jref.scatter_dequantize_ref)
    transit_crc_ref = staticmethod(_jref.transit_crc_ref)


TOL = {"f32": 2e-5, "bf16": 2e-2}
JD = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TD = {"f32": torch.float32, "bf16": torch.bfloat16}


def both(a, dt="f32"):
    """One numpy array -> (jnp, torch) with identical bits in dtype dt."""
    return jnp.asarray(a, JD[dt]), torch.tensor(np.asarray(a)).to(TD[dt])


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _i32(a):
    return jnp.asarray(a, jnp.int32), torch.tensor(np.asarray(a, np.int32))


# ------------------------------------------------------------ paged attention
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,Hkv,hd,P,page,maxp", [
    (2, 4, 2, 64, 16, 16, 4),
    (3, 8, 1, 128, 12, 32, 3),     # MQA
    (1, 2, 2, 64, 4, 8, 2),
])
def test_paged_attention_sweep(B, H, Hkv, hd, P, page, maxp, dt):
    rng = np.random.default_rng(3)
    qj, qt = both(rng.standard_normal((B, H, hd)), dt)
    kj, kt = both(rng.standard_normal((P, page, Hkv, hd)), dt)
    vj, vt = both(rng.standard_normal((P, page, Hkv, hd)), dt)
    btj, btt = _i32(rng.permutation(P)[:B * maxp].reshape(B, maxp))
    slj, slt = _i32(rng.integers(1, page * maxp + 1, (B,)))
    out = ops.paged_attention(qt, kt, vt, btt, slt)
    exp = jref.paged_attention_ref(qj, kj, vj, btj, slj)
    assert out.dtype == TD[dt] and out.shape == (B, H, hd)
    np.testing.assert_allclose(np32(out), np32(exp), atol=TOL[dt],
                               rtol=TOL[dt])


@settings(max_examples=15, deadline=None, database=None)
@given(seq_lens=st.lists(st.integers(1, 64), min_size=1, max_size=4))
def test_paged_attention_respects_lengths(seq_lens):
    """Property: tokens beyond seq_len never influence the output."""
    B = len(seq_lens)
    H, Hkv, hd, page, maxp = 2, 2, 64, 16, 4
    P = B * maxp
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((B, H, hd)), dtype=torch.float32)
    kp = rng.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, Hkv, hd)).astype(np.float32)
    bt = np.arange(P, dtype=np.int32).reshape(B, maxp)
    sl = torch.tensor(seq_lens, dtype=torch.int32)
    out1 = ops.paged_attention(q, torch.tensor(kp), torch.tensor(vp),
                               torch.tensor(bt), sl)
    kp2, vp2 = kp.copy(), vp.copy()
    for b, n in enumerate(seq_lens):
        for pi in range(maxp):
            for off in range(page):
                if pi * page + off >= n:
                    kp2[bt[b, pi], off] = 99.0
                    vp2[bt[b, pi], off] = -99.0
    out2 = ops.paged_attention(q, torch.tensor(kp2), torch.tensor(vp2),
                               torch.tensor(bt), sl)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5,
                               rtol=1e-5)
    exp = jref.paged_attention_ref(jnp.asarray(q.numpy()), jnp.asarray(kp2),
                                   jnp.asarray(vp2), jnp.asarray(bt),
                                   jnp.asarray(seq_lens, jnp.int32))
    np.testing.assert_allclose(out2.numpy(), np.asarray(exp), atol=2e-5,
                               rtol=2e-5)


def test_paged_attention_zero_length_gives_zeros():
    """len == 0 -> a zero row, as the Pallas kernel's clamped l gives."""
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((2, 4, 16)), dtype=torch.float32)
    kp = torch.tensor(rng.standard_normal((4, 8, 2, 16)), dtype=torch.float32)
    bt = torch.arange(4, dtype=torch.int32).reshape(2, 2)
    out = ops.paged_attention(q, kp, kp, bt,
                              torch.tensor([0, 5], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros_like(out[0]))
    assert torch.isfinite(out[1]).all() and out[1].abs().sum() > 0


# ------------------------------------------------------------ flash (prefill)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,S,H,Hkv,hd,causal,window", [
    (1, 24, 24, 4, 2, 16, True, 0),       # the engine's prefill shape
    (2, 16, 16, 8, 1, 32, True, 5),       # MQA, sliding window
    (1, 8, 20, 2, 2, 16, False, 0),       # rectangular, non-causal
])
def test_flash_attention_ref_matches_jax(B, T, S, H, Hkv, hd, causal, window,
                                         dt):
    rng = np.random.default_rng(6)
    qj, qt = both(rng.standard_normal((B, T, H, hd)), dt)
    kj, kt = both(rng.standard_normal((B, S, Hkv, hd)), dt)
    vj, vt = both(rng.standard_normal((B, S, Hkv, hd)), dt)
    out = tref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    exp = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    np.testing.assert_allclose(np32(out), np32(exp), atol=TOL[dt],
                               rtol=TOL[dt])


FLASH_SWEEP = [  # tests/test_kernels.py:21-62, then ragged T/S and hd 96
    (1, 128, 128, 2, 2, 64, True, 0),
    (2, 256, 256, 4, 2, 64, True, 0),
    (1, 128, 384, 8, 1, 128, True, 0),
    (2, 384, 128, 4, 4, 64, True, 0),
    (1, 256, 256, 2, 2, 64, True, 32),
    (1, 256, 256, 2, 2, 64, True, 128),
    (1, 256, 256, 2, 2, 64, True, 500),
    (2, 128, 256, 2, 2, 64, False, 0),
    (1, 100, 100, 4, 2, 64, True, 0),
    (1, 300, 257, 4, 2, 128, True, 0),
    (1, 128, 128, 8, 8, 96, True, 0),
]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("B,T,S,H,Hkv,hd,causal,window", FLASH_SWEEP)
def test_flash_attention_op_matches_jax(B, T, S, H, Hkv, hd, causal, window,
                                        dt):
    """The public op (plain version on the CPU) against the JAX oracle."""
    rng = np.random.default_rng(7)
    qj, qt = both(rng.standard_normal((B, T, H, hd)), dt)
    kj, kt = both(rng.standard_normal((B, S, Hkv, hd)), dt)
    vj, vt = both(rng.standard_normal((B, S, Hkv, hd)), dt)
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    exp = jref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    assert out.dtype == TD[dt] and out.shape == (B, T, H, hd)
    np.testing.assert_allclose(np32(out), np32(exp), atol=TOL[dt],
                               rtol=TOL[dt])


@pytest.mark.parametrize("B,T,S,H,Hkv,hd,causal,window", [
    (1, 64, 64, 4, 2, 32, True, 0),
    (1, 48, 48, 2, 2, 16, True, 20),
    (2, 24, 40, 2, 1, 16, False, 0),
    (1, 40, 33, 3, 3, 96, True, 0),
])
def test_flash_attention_grad_matches_jax_vjp(B, T, S, H, Hkv, hd, causal,
                                              window):
    """d(q, k, v) of the op against ``jax.vjp`` of the oracle, which is
    what the reference's ``_flash_bwd`` returns; f32 within 2e-5."""
    rng = np.random.default_rng(8)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, T, H, hd), (B, S, Hkv, hd), (B, S, Hkv, hd))]
    g = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: _jref.flash_attention_ref(
        q, k, v, causal=causal, window=window), *map(jnp.asarray, arrs))
    exp = vjp(jnp.asarray(g))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrs]
    ops.flash_attention(*leaves, causal=causal, window=window).backward(
        torch.tensor(g))
    for got, e in zip(leaves, exp):
        assert torch.isfinite(got.grad).all()
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(e),
                                   atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------- transit codec
@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("P,page,F", [(8, 16, 128), (4, 32, 256),
                                      (16, 8, 384)])
def test_transit_codec_roundtrip(P, page, F, dt):
    rng = np.random.default_rng(1)
    pj, pt = both(rng.standard_normal((P, page, F)), dt)
    idj, idt = _i32(rng.permutation(P)[:3])
    q, sc = ops.gather_quantize(pt, idt)
    qr, sr = jref.gather_quantize_ref(pj, idj)
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(sc.numpy(), np.asarray(sr))
    # roundtrip error bounded by one quantization step
    restored = ops.scatter_dequantize(torch.zeros_like(pt), idt, q, sc)
    orig = np32(pt)[np.asarray(idj)]
    got = np32(restored)[np.asarray(idj)]
    step = np.abs(orig).max(axis=-1, keepdims=True) / 127.0
    slack = 1e-7 if dt == "f32" else np.abs(orig) * 2 ** -8
    assert (np.abs(got - orig) <= step * 0.75 + slack).all()


@settings(max_examples=6, deadline=None, database=None)
@given(shape=st.sampled_from([(6, 8, 64), (8, 16, 128), (4, 32, 96),
                              (12, 8, 256)]),
       seed=st.integers(0, 2**31 - 1),
       n_ids=st.integers(1, 4),
       dt=st.sampled_from(["f32", "bf16"]))
def test_fused_transit_crc_matches_three_pass_property(shape, seed, n_ids,
                                                       dt):
    """The fused codec (plain version) is bit-identical on q, scales and
    crc to the three-pass JAX composition gather_quantize_ref ->
    transit_crc_ref, every crc equals zlib.adler32 of the page bytes, and
    the restore writes what scatter_dequantize_ref writes."""
    P, page, F = shape
    rng = np.random.default_rng(seed)
    pj, pt = both(rng.standard_normal((P, page, F)), dt)
    idj, idt = _i32(rng.permutation(P)[:min(n_ids, P)])
    qr, sr = jref.gather_quantize_ref(pj, idj)
    crc_r = jref.transit_crc_ref(qr)

    q, sc, crc = ops.gather_quantize_crc(pt, idt)
    assert np.array_equal(q.numpy(), np.asarray(qr))
    assert np.array_equal(sc.numpy(), np.asarray(sr))
    assert crc.dtype == torch.int64
    assert np.array_equal(crc.numpy(), crc_r.astype(np.int64))
    for page_q, c in zip(q.numpy(), crc.tolist()):
        assert c == zlib.adler32(page_q.tobytes())

    exp_pool = jref.scatter_dequantize_ref(jnp.zeros_like(pj), idj, qr, sr)
    pool = torch.zeros_like(pt)
    new_pool, crc2 = ops.scatter_dequantize_crc(pool, idt, q, sc)
    assert new_pool is pool                      # in place
    assert np.array_equal(crc2.numpy(), crc.numpy())
    assert np.array_equal(np32(new_pool), np32(exp_pool))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("L,P,page,F", [(2, 6, 4, 32), (3, 5, 16, 48),
                                        (1, 4, 8, 256)])
def test_batched_codec_over_a_stack_matches_jax_per_unit(L, P, page, F, dt):
    """The codec over a (L, 2, P, page, F) stack, one call for units in
    mixed order, is bit-identical on q, scales and crc to the JAX oracles
    run eagerly on each unit's pool and page alone; each crc is
    zlib.adler32 of the unit's bytes; the restore into other pages writes
    what scatter_dequantize_ref writes there and nothing else."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((L, 2, P, page, F)) * rng.uniform(
        1e-3, 1e2, (L, 2, P, page, 1))
    x[:, :, :, 0] = 0.0                               # an all-zero row
    xj, xt = both(x, dt)
    pools_j = xj.reshape(2 * L, P, page, F)
    stack = xt.view(2 * L, P, page, F)
    half = P // 2
    pairs = np.array([(s, p) for s in range(2 * L) for p in range(half)],
                     np.int32)
    units = pairs[rng.permutation(len(pairs))]
    q, sc, crc = ops.gather_quantize_crc_units(stack, torch.tensor(units))
    assert crc.dtype == torch.int64 and q.shape == (len(units), page, F)
    for u, (slot, p) in enumerate(units):
        qr, sr = jref.gather_quantize_ref(pools_j[slot],
                                          jnp.asarray([p], jnp.int32))
        assert np.array_equal(q[u].numpy(), np.asarray(qr)[0])
        assert np.array_equal(sc[u].numpy(), np.asarray(sr)[0])
        assert int(crc[u]) == int(jref.transit_crc_ref(qr)[0]) \
            == zlib.adler32(q[u].numpy().tobytes())
    dst = units + np.array([0, half], np.int32)       # the other pages
    before = stack.clone()
    out, rcrc = ops.scatter_dequantize_crc_units(stack, torch.tensor(dst), q,
                                                 sc)
    assert out is stack and torch.equal(rcrc, crc)
    written = np.zeros((2 * L, P), bool)
    for u, (slot, p) in enumerate(dst):
        exp = jref.scatter_dequantize_ref(
            pools_j[slot], jnp.asarray([p], jnp.int32),
            jnp.asarray(q[u].numpy())[None], jnp.asarray(sc[u].numpy())[None])
        assert np.array_equal(np32(stack[slot, p]), np32(exp[p]))
        written[slot, p] = True
    keep = torch.tensor(~written)
    assert torch.equal(stack[keep], before[keep])


def test_fused_crc_detects_payload_corruption():
    """Flipping ONE byte of a quantized page moves its crc only."""
    rng = np.random.default_rng(9)
    pool = torch.tensor(rng.standard_normal((4, 16, 64)), dtype=torch.float32)
    ids = torch.tensor([1, 3], dtype=torch.int32)
    q, sc, crc = ops.gather_quantize_crc(pool, ids)
    qc = q.clone()
    qc[0, 3, 7] ^= 1
    _, crc2 = ops.scatter_dequantize_crc(torch.zeros_like(pool), ids, qc, sc)
    assert int(crc2[0]) != int(crc[0])
    assert int(crc2[1]) == int(crc[1])
    assert int(crc2[0]) == zlib.adler32(qc[0].numpy().tobytes())


def test_scatter_preserves_other_pages():
    rng = np.random.default_rng(6)
    pool = torch.tensor(rng.standard_normal((8, 16, 128)), dtype=torch.float32)
    before = pool.clone()
    ids = torch.tensor([2, 5], dtype=torch.int32)
    q, sc = ops.gather_quantize(pool, ids)
    out = ops.scatter_dequantize(pool, ids, q, sc)
    for p in range(8):
        if p not in (2, 5):
            assert torch.equal(out[p], before[p])


def test_transit_crc_ref_matches_zlib_on_extreme_bytes():
    """All-0x80 and all-0x7f pages: the largest sums the checksum sees."""
    for fill in (-128, 127, -1):
        q = torch.full((2, 16, 256), fill, dtype=torch.int8)
        crc = tref.transit_crc_ref(q)
        assert crc.tolist() == [zlib.adler32(q[0].numpy().tobytes())] * 2
        assert crc.tolist() == jref.transit_crc_ref(q.numpy()).tolist()


# --------------------------------------------------- wrappers off the card
def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch for CUDA tensors only: a CPU tensor is
    refused before anything is built or launched."""
    q = torch.zeros((1, 2, 16))
    pool = torch.zeros((2, 4, 2, 16))
    table = torch.zeros((1, 1), dtype=torch.int32)
    lens = torch.ones((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        paged_attention_cuda(q, pool, pool, table, lens)
    qf = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_cuda(qf, qf, qf)
    flat = torch.zeros((2, 4, 32))
    ids = torch.zeros((1,), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        gather_quantize_cuda(flat, ids)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        scatter_dequantize_cuda(flat, ids, torch.zeros((1, 4, 32), dtype=torch.int8),
                                torch.ones((1, 4)))
    assert _build.launch_counts() == {}


def test_ops_refuse_devices_without_a_version():
    t = torch.zeros((2, 4, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.gather_quantize_crc(t, torch.zeros((1,), dtype=torch.int32))


def test_build_library_name_follows_source_and_flags(monkeypatch):
    """A library is keyed by its source's and the flags' hash: an edit
    selects a new build, an unchanged source the existing one."""
    a = _build.lib_path("block_transit")
    assert a == _build.lib_path("block_transit")
    assert a.parent == _build.BUILD_DIR and a.name.startswith("libblock_transit-")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.lib_path("block_transit") != a
