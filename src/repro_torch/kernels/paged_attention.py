"""Paged decode attention: the block table's lba -> pba walk fused into the
attention gather (``csrc/paged_attention.cu``), and its plain version.

The kernel wrapper launches for CUDA tensors only and raises on anything
it does not take; ``ops.paged_attention`` picks the plain version for CPU
tensors.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import paged_attention_ref as paged_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_REP = 8                  # PA_MAX_REP in csrc/paged_attention.cu
MAX_HD = 256                 # PA_MAX_HD in csrc/paged_attention.cu
N_SM = 132                   # streaming multiprocessors of the H100 SXM
MAX_PPS = 64                 # pages one split walks at most (plan's cap)
_SMEM_LIMIT = 48 * 1024      # a block's shared memory without opt-in

__all__ = ["paged_attention_cuda", "paged_attention_plain", "split_plan"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [vp] * 9 + [i] * 9 + [
            ctypes.c_float, i, vp]
        lib.paged_attention_launch.restype = i
        lib._typed = True
    return lib


def split_plan(B: int, Hkv: int, max_pages: int) -> tuple[int, int]:
    """(pages_per_split, n_split) for a (B, max_pages) table: the largest
    power of two ``pages_per_split`` up to 64 for which B * Hkv * n_split
    still reaches 2 x 132 blocks, or 1 page a split where the table is too
    narrow for that.  From shapes only: reading ``seq_lens`` on the host
    would stall the stream every layer."""
    pps = 1
    while pps * 2 <= min(max_pages, MAX_PPS) \
            and B * Hkv * -(-max_pages // (pps * 2)) >= 2 * N_SM:
        pps *= 2
    return pps, -(-max_pages // pps)


def _smem_bytes(n_rep: int, hd: int, pps: int) -> int:
    """paged_attention_smem_bytes in csrc/paged_attention.cu: the warps'
    merge area for n_rep rounded up to a power of two, and the split's
    table entries."""
    rows = 1 << max(n_rep - 1, 0).bit_length()
    return 4 * rows * (2 + hd) * 4 + pps * 4


def paged_attention_cuda(q, k_pool, v_pool, block_table, seq_lens, *,
                         pages_per_split: int | None = None,
                         return_lse: bool = False):
    """One decode step on the card.  q: (B, H, hd); pools: (P, page, Hkv,
    hd) in q's dtype (f32 or bf16); block_table: (B, max_pages) int32;
    seq_lens: (B,) int32 -> (B, H, hd) in q's dtype.  Every entry of a
    table row below ``ceil(len / page)`` must name a page of the pool.
    ``pages_per_split`` overrides ``split_plan`` (tests force 1 and
    max_pages).  ``return_lse`` also returns each row's log-sum-exp of its
    scaled scores, (B, H) f32, -inf for a row of length 0 (whose output is
    0), written by the combine launch.  Takes n_rep = H / Hkv <= 8 and hd
    <= 256, and raises on anything else.

    Replaces ``src/repro/kernels/paged_attention.py:paged_attention_pallas``.
    Bound on the H100 by the bytes it reads: each live K and V page once,
    ``sum_b ceil(len_b / page) * page * Hkv * hd * 2 * sizeof(dtype)`` at
    3.35 TB/s; at decode sizes that is a few microseconds, and latency
    dominates.  Design: flash-decoding, two launches.  Grid (B, Hkv,
    n_split): each block takes a contiguous range of the table, reads K and
    V rows with 16-byte loads into registers once for all n_rep query
    heads, and writes its (m, l, acc) to f32 scratch; a (B, H) combine
    weighs the splits by their maxima.
    """
    tensors = (q, k_pool, v_pool, block_table, seq_lens)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("paged_attention_cuda takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged_attention_cuda: tensors on different devices")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_attention_cuda: q and pools must share one "
                        f"dtype of {list(_DTYPES)}, got {q.dtype}, "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention_cuda: block_table and seq_lens "
                        "must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention_cuda: tensors must be contiguous")
    B, H, hd = q.shape
    P, page, Hkv, hd_k = k_pool.shape
    if v_pool.shape != k_pool.shape or hd_k != hd or H % Hkv != 0:
        raise ValueError(f"paged_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}/{tuple(v_pool.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(seq_lens.shape) != (B,):
        raise ValueError("paged_attention_cuda: block_table must be "
                         "(B, max_pages) and seq_lens (B,)")
    n_rep = H // Hkv
    if n_rep > MAX_REP:
        raise ValueError(f"paged_attention_cuda: n_rep {n_rep} exceeds "
                         f"{MAX_REP}")
    if not 0 < hd <= MAX_HD:
        raise ValueError(f"paged_attention_cuda: hd {hd} outside "
                         f"1..{MAX_HD}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    max_pages = block_table.shape[1]
    if B == 0 or max_pages == 0 or H == 0:
        out.zero_()
        return (out, lse.fill_(-math.inf)) if return_lse else out
    pps, n_split = split_plan(B, Hkv, max_pages)
    if pages_per_split is not None:
        if not 0 < pages_per_split <= max_pages:
            raise ValueError(f"paged_attention_cuda: pages_per_split "
                             f"{pages_per_split} outside 1..{max_pages}")
        pps, n_split = pages_per_split, -(-max_pages // pages_per_split)
    if _smem_bytes(n_rep, hd, pps) > _SMEM_LIMIT:
        raise ValueError(f"paged_attention_cuda: {pps} pages a split take "
                         f"too much shared memory")
    # one f32 scratch for both: acc (B, H, n_split, hd), then (m, l)
    n_rows = B * H * n_split
    scratch = torch.empty(n_rows * (hd + 2), dtype=torch.float32,
                          device=q.device)
    acc, ml = scratch[:n_rows * hd], scratch[n_rows * hd:]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            ml.data_ptr(), acc.data_ptr(),
            None if lse is None else lse.data_ptr(), B, H, Hkv, hd, P, page,
            max_pages, pps, n_split, 1.0 / math.sqrt(hd), _DTYPES[q.dtype],
            stream)
    _build.check(rc, "paged_attention")
    _build.count_launch("paged_attention")
    return (out, lse) if return_lse else out
