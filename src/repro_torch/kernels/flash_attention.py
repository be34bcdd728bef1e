"""Flash attention for the prefill, two hand-written kernels and their
plain version: bf16 on Hopper's tensor cores (``csrc/flash_attention_sm90.cu``)
and a SIMT kernel for the rest (``csrc/flash_attention.cu``).

The kernel wrapper launches for CUDA tensors only and raises on anything
it does not take; ``ops.flash_attention`` picks the plain version for CPU
tensors and adds the gradient.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 256                    # FA_MAX_HD in csrc/flash_attention.cu

__all__ = ["flash_attention_cuda", "flash_attention_plain", "flash_route",
           "padded_hd"]


def flash_route(dtype, hd: int, S: int = 1) -> str:
    """Which kernel takes an input: ``"tc"`` (tensor cores, TMA) for bf16
    with hd % 8 == 0 and at least one key, ``"simt"`` for the rest.  f32
    stays off the tensor cores because they would compute in TF32, which
    keeps about three decimal digits and misses the 2e-5 tolerance; hd % 8
    != 0 stays off TMA because every global stride of a tensor map must be
    a multiple of 16 bytes; S == 0 gives a tensor map no extent.  (The
    wrapper also sends a tensor whose address is not 16-byte aligned to
    the SIMT kernel, for the same reason.)"""
    return "tc" if dtype == torch.bfloat16 and hd % 8 == 0 and S > 0 \
        else "simt"


def padded_hd(hd: int) -> int:
    """The head width the tensor-core kernel keeps in shared memory: 64,
    128 or 256 (TMA's 128-byte swizzled rows of 64 bf16; zero-filled past
    hd)."""
    return 64 if hd <= 64 else 128 if hd <= 128 else 256


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 6 + [
            ctypes.c_float, i, i, i, i, vp]
        lib.flash_attention_launch.restype = i
        lib._typed = True
    return lib


def _lib_tc() -> ctypes.CDLL:
    lib = _build.load("flash_attention_sm90")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_tc_launch.argtypes = [vp] * 4 + [i] * 7 + [
            ctypes.c_float, i, i, i, vp]
        lib.flash_attention_tc_launch.restype = i
        lib._typed = True
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         q_offset: int = 0):
    """Attention on the card.  q: (B, T, H, hd); k, v: (B, S, Hkv, hd), one
    dtype of f32 / bf16, contiguous -> (B, T, H, hd) in q's dtype.  T and S
    take any length; key positions start at 0, query positions at
    ``q_offset`` (a shard of the query rows).  The kernel is
    the one ``flash_route`` names (bf16 with hd % 8 == 0 on the tensor
    cores, the rest on the SIMT kernel).

    Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
    Bound on the H100 by operations at prefill lengths: 4 * hd flops per
    valid (query head, q, k) pair, at 989 TFLOP/s in bf16.  The
    tensor-core kernel: one block per (128-row q tile, q head, batch), a
    TMA producer warpgroup feeding a 3-stage ring of 128-token K/V tiles
    (hd up to 128; at hd 256 a 2-stage ring of 64-token tiles) to two
    consumer warpgroups that run Q K^T and P V on ``wgmma``, online
    softmax in registers.  The SIMT kernel runs the same algorithm on the f32 FMA
    units from shared-memory tiles of 64.  Both skip the tiles that the
    causal or window mask hides entirely.  Launches count as
    ``flash_attention`` (every call) and ``flash_attention_tc`` (the
    tensor-core kernel).
    """
    tensors = (q, k, v)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("flash_attention_cuda takes CUDA tensors only")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("flash_attention_cuda: tensors on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_cuda: q, k and v must share one "
                        f"dtype of {list(_DTYPES)}, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention_cuda: tensors must be contiguous")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: q must be (B, T, H, hd) and "
                         f"k, v (B, S, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention_cuda: window {window} or "
                         f"q_offset {q_offset} < 0")
    B, T, H, hd = q.shape
    Bk, S, Hkv, hd_k = k.shape
    if Bk != B or hd_k != hd or Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    if not 0 < hd <= MAX_HD:
        raise ValueError(f"flash_attention_cuda: head width {hd} outside "
                         f"1..{MAX_HD}")
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    route = flash_route(q.dtype, hd, S) if aligned else "simt"
    out = torch.empty_like(q)
    if B == 0 or T == 0 or H == 0:
        return out
    scale = 1.0 / math.sqrt(hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "tc":
            rc = _lib_tc().flash_attention_tc_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                T, S, H, Hkv, hd, padded_hd(hd), scale, int(causal),
                int(window), int(q_offset), stream)
        else:
            rc = _lib().flash_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B,
                T, S, H, Hkv, hd, scale, int(causal), int(window),
                int(q_offset), _DTYPES[q.dtype], stream)
    _build.check(rc, f"flash_attention ({route})")
    _build.count_launch("flash_attention")
    if route == "tc":
        _build.count_launch("flash_attention_tc")
    return out
