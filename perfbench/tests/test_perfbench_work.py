"""The operation and byte counts behind the rooflines and MFUs, against
arithmetic by hand at two shapes each."""
import pytest

from perfbench.harness import work


@pytest.mark.parametrize("T,H,Hkv,hd", [(4, 2, 1, 8), (3000, 32, 32, 96)])
def test_flash_work_by_hand(T, H, Hkv, hd):
    ops, n_bytes = work.flash_work(1, T, T, H, Hkv, hd)
    pairs = T * (T + 1) // 2                     # causal: row t keeps t + 1
    assert ops == 4 * pairs * H * hd
    assert n_bytes == 2 * (T * H * hd * 2 + T * Hkv * hd * 2)


def test_flash_pairs_by_hand():
    assert work.flash_pairs(4, 4, True, 0) == 10
    assert work.flash_pairs(4, 4, False, 0) == 16
    assert work.flash_pairs(4, 4, True, 2) == 7    # 1 + 2 + 2 + 2


@pytest.mark.parametrize("lens,H,Hkv,hd", [([5, 7], 4, 2, 8),
                                           ([3616] * 32, 32, 32, 96)])
def test_paged_work_by_hand(lens, H, Hkv, hd):
    ops, n_bytes = work.paged_work(lens, H, Hkv, hd)
    n = sum(lens)
    assert ops == 4 * n * H * hd
    assert n_bytes == 2 * (2 * n * Hkv * hd + 2 * len(lens) * H * hd)


def test_model_flops_by_hand():
    m = dict(L=2, d=8, H=2, Hkv=1, hd=4, f=16, V=10)
    per_tok = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16     # q, k+v, o, mlp
    assert work.matmul_params(8, 2, 1, 4, 16) == per_tok
    assert work.prefill_flops(3, **m) == 2 * (2 * per_tok * 3
                                              + 4 * 2 * 4 * 6) + 2 * 8 * 10
    assert work.decode_flops([3, 5], **m) == 2 * (2 * per_tok * 2
                                                  + 4 * 2 * 4 * 8) \
        + 2 * 8 * 10 * 2


def test_bound_takes_the_slower_of_bytes_and_operations():
    ms, what = work.bound(3.35e9, 1.0, work.BF16_OPS_PER_S)
    assert what == "bytes" and ms == pytest.approx(1.0)
    ms, what = work.bound(1.0, 989e9, work.BF16_OPS_PER_S)
    assert what == "operations" and ms == pytest.approx(1.0)
