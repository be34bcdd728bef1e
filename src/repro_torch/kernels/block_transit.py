"""Block transit codec: the KV page spill (gather + int8 quantize + Adler-32)
and restore (dequantize + scatter + Adler-32) passes of
``csrc/block_transit.cu``, and their plain versions.

Both work on a batch of units in one pass: ``stack`` is (S, P, page, F),
S pools of P pages (the KV cache's layer x {K, V} slots), and ``units`` is
an (n, 2) int32 list of (slot, page) pairs.  A single pool is the stack of
one slot (``one_slot``).  The kernel wrappers launch for CUDA tensors only
and raise on anything they do not take; ``ops`` picks the plain versions
for CPU tensors.  The scatter writes the stack in place (the JAX kernels
aliased the pool to their output) and returns it.  Units are unique within
one call.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import gather_quantize_ref, transit_crc_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPS = 1e-12

__all__ = ["one_slot", "gather_quantize_cuda", "scatter_dequantize_cuda",
           "gather_quantize_plain", "gather_quantize_crc_plain",
           "scatter_dequantize_plain", "scatter_dequantize_crc_plain"]


def one_slot(pool, page_ids):
    """A single pool (P, page, F) and its page ids (n,) as the codec's
    stack of one slot and its (n, 2) unit list."""
    return pool[None], torch.stack((torch.zeros_like(page_ids), page_ids), 1)


def _lib() -> ctypes.CDLL:
    lib = _build.load("block_transit")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gather_quantize_launch.argtypes = [vp] * 5 + [i] * 5 + [
            ctypes.c_float, i, vp]
        lib.gather_quantize_launch.restype = i
        lib.scatter_dequantize_launch.argtypes = [vp] * 5 + [i] * 6 + [vp]
        lib.scatter_dequantize_launch.restype = i
        lib._typed = True
    return lib


def _check_stack_units(stack, units, what: str) -> None:
    if not (stack.is_cuda and units.is_cuda):
        raise ValueError(f"{what} takes CUDA tensors only")
    if stack.device != units.device:
        raise ValueError(f"{what}: tensors on different devices")
    if stack.dtype not in _DTYPES:
        raise TypeError(f"{what}: stack dtype {stack.dtype} not in "
                        f"{list(_DTYPES)}")
    if units.dtype != torch.int32 or units.dim() != 2 or units.shape[1] != 2:
        raise TypeError(f"{what}: units must be an (n, 2) int32 tensor")
    if stack.dim() != 4:
        raise ValueError(f"{what}: stack must be (S, P, page, F), got "
                         f"{tuple(stack.shape)}")
    if not (stack.is_contiguous() and units.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")


def gather_quantize_cuda(stack, units, *, with_crc: bool = True):
    """Spill pass on the card.  stack: (S, P, page, F) f32/bf16; units:
    (n, 2) int32 (slot, page) -> (q (n, page, F) int8, scales (n, page)
    f32, crcs (n,) int64 holding the uint32 Adler-32 of each unit's int8
    bytes); without ``with_crc`` only (q, scales).  One launch for all n.

    Replaces ``src/repro/kernels/block_transit.py:gather_quantize_crc_pallas``
    (and ``gather_quantize_pallas`` as ``with_crc=False``).  Bound on the
    H100 by bytes: one read of each unit and one write of its int8 form
    and scales, at 3.35 TB/s.  Design: one block per unit, so a page-out
    of every page, layer and K/V of a sequence is one launch that fills the
    card; lane groups of a warp each take a row with 16-byte loads and
    stores, reduce its absmax with shuffles and quantize it, and every
    thread folds the bytes it wrote into 64-bit Adler partial sums that the
    block reduces once, so the checksum costs no second pass.
    """
    what = "gather_quantize_cuda"
    _check_stack_units(stack, units, what)
    S, P, page, F = stack.shape
    n = units.shape[0]
    dev = stack.device
    q = torch.empty((n, page, F), dtype=torch.int8, device=dev)
    scales = torch.empty((n, page), dtype=torch.float32, device=dev)
    crcs = torch.empty((n,), dtype=torch.int64, device=dev) if with_crc \
        else None
    if n:
        lib = _lib()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.gather_quantize_launch(
                stack.data_ptr(), units.data_ptr(), q.data_ptr(),
                scales.data_ptr(), crcs.data_ptr() if with_crc else None,
                n, S, P, page, F, EPS, _DTYPES[stack.dtype], stream)
        _build.check(rc, what)
        _build.count_launch("gather_quantize_crc" if with_crc
                            else "gather_quantize")
    return (q, scales, crcs) if with_crc else (q, scales)


def scatter_dequantize_cuda(stack, units, q, scales, *,
                            with_crc: bool = True):
    """Restore pass on the card, in place: ``stack[slot_i][page_i] = q[i] *
    scales[i][:, None]`` in the stack's dtype for each unit i; other pages
    are untouched and units must be unique.  Returns ``(stack, crcs)``
    (crcs: (n,) int64, the Adler-32 of each int8 payload as received), or
    ``stack`` without ``with_crc``.  One launch for all n.

    Replaces ``src/repro/kernels/block_transit.py:scatter_dequantize_crc_pallas``
    (and ``scatter_dequantize_pallas`` as ``with_crc=False``).  Bound on the
    H100 by bytes: one read of the int8 payload and scales and one write
    of the pages.  Design: one block per unit writes only that unit's page,
    so no pool copy is made, with 16-byte loads and stores; the checksum of
    the bytes it reads rides the same loop.
    """
    what = "scatter_dequantize_cuda"
    _check_stack_units(stack, units, what)
    S, P, page, F = stack.shape
    n = units.shape[0]
    if q.dtype != torch.int8 or tuple(q.shape) != (n, page, F):
        raise ValueError(f"{what}: q must be int8 {(n, page, F)}, got "
                         f"{q.dtype} {tuple(q.shape)}")
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n, page):
        raise ValueError(f"{what}: scales must be f32 {(n, page)}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if q.device != stack.device or scales.device != stack.device:
        raise ValueError(f"{what}: tensors on different devices")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{what}: tensors must be contiguous")
    crcs = torch.empty((n,), dtype=torch.int64, device=stack.device) \
        if with_crc else None
    if n:
        lib = _lib()
        with torch.cuda.device(stack.device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = lib.scatter_dequantize_launch(
                stack.data_ptr(), units.data_ptr(), q.data_ptr(),
                scales.data_ptr(), crcs.data_ptr() if with_crc else None,
                n, S, P, page, F, _DTYPES[stack.dtype], stream)
        _build.check(rc, what)
        _build.count_launch("scatter_dequantize_crc" if with_crc
                            else "scatter_dequantize")
    return (stack, crcs) if with_crc else stack


# ------------------------------------------------------------ plain versions
def _pages(stack, units):
    """The stack as one pool of S * P pages, and each unit's page in it."""
    S, P, page, F = stack.shape
    return stack.view(S * P, page, F), units[:, 0].long() * P + units[:, 1]


def gather_quantize_plain(stack, units):
    return gather_quantize_ref(*_pages(stack, units), eps=EPS)


def gather_quantize_crc_plain(stack, units):
    q, scales = gather_quantize_plain(stack, units)
    return q, scales, transit_crc_ref(q)


def scatter_dequantize_plain(stack, units, q, scales):
    """In place, like the kernel; returns the stack."""
    pool, ids = _pages(stack, units)
    pool[ids] = (q.float() * scales[..., None]).to(stack.dtype)
    return stack


def scatter_dequantize_crc_plain(stack, units, q, scales):
    return scatter_dequantize_plain(stack, units, q, scales), \
        transit_crc_ref(q)
