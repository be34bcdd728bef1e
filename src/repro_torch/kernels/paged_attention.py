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
_SMEM_LIMIT = 48 * 1024        # static-launch shared memory, no opt-in

__all__ = ["paged_attention_cuda", "paged_attention_plain"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_attention_launch.argtypes = [vp] * 6 + [i] * 7 + [
            ctypes.c_float, i, vp]
        lib.paged_attention_launch.restype = i
        lib.paged_attention_smem_bytes.argtypes = [i, i, i]
        lib.paged_attention_smem_bytes.restype = ctypes.c_longlong
        lib.paged_attention_max_rows_hd.argtypes = []
        lib.paged_attention_max_rows_hd.restype = i
        lib._typed = True
    return lib


def paged_attention_cuda(q, k_pool, v_pool, block_table, seq_lens):
    """One decode step on the card.  q: (B, H, hd); pools: (P, page, Hkv,
    hd) in q's dtype (f32 or bf16); block_table: (B, max_pages) int32;
    seq_lens: (B,) int32 -> (B, H, hd) in q's dtype.  Every entry of a
    table row below ``ceil(len / page)`` must name a page of the pool.

    Replaces ``src/repro/kernels/paged_attention.py:paged_attention_pallas``.
    Bound on the H100 by the bytes it reads: each live K and V page once,
    ``sum_b ceil(len_b / page) * page * Hkv * hd * 2 * sizeof(dtype)`` at
    3.35 TB/s; at decode sizes that is under a microsecond and the launch
    dominates.  Design: grid (B, Hkv), so one block reads each page of its
    kv head once for all ``n_rep`` query heads that share it, staging one
    (page, hd) K and V tile in shared memory; the online-softmax state and
    the accumulator stay in f32 registers.
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
    lib = _lib()
    n_rep = H // Hkv
    if n_rep * hd > lib.paged_attention_max_rows_hd():
        raise ValueError(f"paged_attention_cuda: n_rep * hd = {n_rep * hd} "
                         f"exceeds {lib.paged_attention_max_rows_hd()}")
    if lib.paged_attention_smem_bytes(n_rep, hd, page) > _SMEM_LIMIT:
        raise ValueError("paged_attention_cuda: page * hd too large for "
                         "one block's shared memory")
    out = torch.empty_like(q)
    if B == 0:
        return out
    max_pages = block_table.shape[1]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            B, H, Hkv, hd, P, page, max_pages, 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], stream)
    _build.check(rc, "paged_attention")
    _build.count_launch("paged_attention")
    return out
