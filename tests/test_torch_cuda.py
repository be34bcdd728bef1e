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
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P,page,F,n", [(64, 16, 256, 1), (16, 8, 384, 4),
                                        (16, 16, 32, 3)])
def test_transit_codec_kernels_bit_exact(card, P, page, F, n, dtype):
    g = torch.Generator(device=card).manual_seed(1)
    pool = (torch.randn((P, page, F), generator=g, device=card) * 3).to(dtype)
    ids = torch.randperm(P, generator=g, device=card)[:2 * n].int()
    src, dst = ids[:n].contiguous(), ids[n:].contiguous()
    q, s, c = gather_quantize_cuda(pool, src)
    qp, sp, cp = gather_quantize_crc_plain(pool, src)
    assert torch.equal(q, qp) and torch.equal(s, sp) and torch.equal(c, cp)
    qh = q.cpu().numpy()
    assert c.tolist() == [zlib.adler32(qh[i].tobytes()) for i in range(n)]
    pk, pp = pool.clone(), pool.clone()
    _, rc = scatter_dequantize_cuda(pk, dst, q, s)
    _, rcp = scatter_dequantize_crc_plain(pp, dst, q, s)
    torch.cuda.synchronize()
    assert torch.equal(pk, pp) and torch.equal(rc, c) and torch.equal(rcp, c)


def test_ops_route_cuda_tensors_to_the_kernels(card):
    pool = torch.randn((8, 16, 64), device=card)
    ids = torch.tensor([3], dtype=torch.int32, device=card)
    before = _build.launch_counts()
    q, s, _ = ops.gather_quantize_crc(pool, ids)
    ops.scatter_dequantize_crc(pool, ids, q, s)
    after = _build.launch_counts()
    for name in ("gather_quantize_crc", "scatter_dequantize_crc"):
        assert after.get(name, 0) == before.get(name, 0) + 1
