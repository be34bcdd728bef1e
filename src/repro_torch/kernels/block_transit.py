"""Block transit codec: the KV page spill (gather + int8 quantize + Adler-32)
and restore (dequantize + scatter + Adler-32) passes of
``csrc/block_transit.cu``, and their plain versions.

The kernel wrappers launch for CUDA tensors only and raise on anything
they do not take; ``ops`` picks the plain versions for CPU tensors.  The
scatter writes the pool in place (the JAX kernels aliased the pool to
their output) and returns it.  Page ids are unique within one call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import gather_quantize_ref, transit_crc_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPS = 1e-12

__all__ = ["gather_quantize_cuda", "scatter_dequantize_cuda",
           "gather_quantize_plain", "gather_quantize_crc_plain",
           "scatter_dequantize_plain", "scatter_dequantize_crc_plain"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("block_transit")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_quantize_launch.argtypes = [vp] * 5 + [i] * 4 + [
            ctypes.c_float, i, vp]
        lib.gather_quantize_launch.restype = i
        lib.scatter_dequantize_launch.argtypes = [vp] * 5 + [i] * 5 + [vp]
        lib.scatter_dequantize_launch.restype = i
        lib._typed = True
    return lib


def _check_pool_ids(pool, page_ids, what: str) -> None:
    if not (pool.is_cuda and page_ids.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if pool.device != page_ids.device:
        raise ValueError(f"{what}: tensors on different devices")
    if pool.dtype not in _DTYPES:
        raise TypeError(f"{what}: pool dtype {pool.dtype} not in "
                        f"{list(_DTYPES)}")
    if page_ids.dtype != torch.int32 or page_ids.dim() != 1:
        raise TypeError(f"{what}: page_ids must be a 1-d int32 tensor")
    if pool.dim() != 3:
        raise ValueError(f"{what}: pool must be (P, page, F), got "
                         f"{tuple(pool.shape)}")
    if not (pool.is_contiguous() and page_ids.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")


def gather_quantize_cuda(pool, page_ids, *, with_crc: bool = True):
    """Spill pass on the card.  pool: (P, page, F) f32/bf16; page_ids: (n,)
    int32 -> (q (n, page, F) int8, scales (n, page) f32, crcs (n,) int64
    holding the uint32 Adler-32 of each page's int8 bytes); without
    ``with_crc`` only (q, scales).

    Replaces ``src/repro/kernels/block_transit.py:gather_quantize_crc_pallas``
    (and ``gather_quantize_pallas`` as ``with_crc=False``).  Bound on the
    H100 by bytes: one read of each page and one write of its int8 form
    and scales, at 3.35 TB/s, which for one 16 x 256 page is nanoseconds,
    so the launch dominates.  Design: one block per page; a warp per row
    reduces the absmax with shuffles and quantizes the row, and every
    thread folds the bytes it wrote into 64-bit Adler partial sums that
    the block reduces once, so the checksum costs no second pass.
    """
    what = "gather_quantize_cuda"
    _check_pool_ids(pool, page_ids, what)
    P, page, F = pool.shape
    n = page_ids.shape[0]
    dev = pool.device
    q = torch.empty((n, page, F), dtype=torch.int8, device=dev)
    scales = torch.empty((n, page), dtype=torch.float32, device=dev)
    crcs = torch.empty((n,), dtype=torch.int64, device=dev) if with_crc \
        else None
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gather_quantize_launch(
                pool.data_ptr(), page_ids.data_ptr(), q.data_ptr(),
                scales.data_ptr(), crcs.data_ptr() if with_crc else None,
                n, P, page, F, EPS, _DTYPES[pool.dtype], stream)
        _build.check(rc, what)
        _build.count_launch("gather_quantize_crc" if with_crc
                            else "gather_quantize")
    return (q, scales, crcs) if with_crc else (q, scales)


def scatter_dequantize_cuda(pool, page_ids, q, scales, *,
                            with_crc: bool = True):
    """Restore pass on the card, in place: ``pool[page_ids[i]] = q[i] *
    scales[i][:, None]`` in the pool's dtype; other pages are untouched and
    ids must be unique.  Returns ``(pool, crcs)`` (crcs: (n,) int64, the
    Adler-32 of each int8 payload as received), or ``pool`` without
    ``with_crc``.

    Replaces ``src/repro/kernels/block_transit.py:scatter_dequantize_crc_pallas``
    (and ``scatter_dequantize_pallas`` as ``with_crc=False``).  Bound on the
    H100 by bytes: one read of the int8 payload and scales and one write
    of the page; the launch dominates at one page.  Design: one block per
    page writes only that page, so no pool copy is made, and the checksum
    of the bytes it reads rides the same loop.
    """
    what = "scatter_dequantize_cuda"
    _check_pool_ids(pool, page_ids, what)
    P, page, F = pool.shape
    n = page_ids.shape[0]
    if q.dtype != torch.int8 or tuple(q.shape) != (n, page, F):
        raise ValueError(f"{what}: q must be int8 {(n, page, F)}, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n, page):
        raise ValueError(f"{what}: scales must be f32 {(n, page)}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if q.device != pool.device or scales.device != pool.device:
        raise ValueError(f"{what}: tensors on different devices")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")
    crcs = torch.empty((n,), dtype=torch.int64, device=pool.device) \
        if with_crc else None
    if n:
        lib = _lib()
        with torch.cuda.device(pool.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.scatter_dequantize_launch(
                pool.data_ptr(), page_ids.data_ptr(), q.data_ptr(),
                scales.data_ptr(), crcs.data_ptr() if with_crc else None,
                n, P, page, F, _DTYPES[pool.dtype], stream)
        _build.check(rc, what)
        _build.count_launch("scatter_dequantize_crc" if with_crc
                            else "scatter_dequantize")
    return (pool, crcs) if with_crc else pool


# ------------------------------------------------------------ plain versions
def gather_quantize_plain(pool, page_ids):
    return gather_quantize_ref(pool, page_ids, eps=EPS)


def gather_quantize_crc_plain(pool, page_ids):
    q, scales = gather_quantize_ref(pool, page_ids, eps=EPS)
    return q, scales, transit_crc_ref(q)


def scatter_dequantize_plain(pool, page_ids, q, scales):
    """In place, like the kernel; returns the pool."""
    pool[page_ids.long()] = (q.float() * scales[..., None]).to(pool.dtype)
    return pool


def scatter_dequantize_crc_plain(pool, page_ids, q, scales):
    return scatter_dequantize_plain(pool, page_ids, q, scales), \
        transit_crc_ref(q)
