"""Blocked flash attention for the prefill (``csrc/flash_attention.cu``),
and its plain version.

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
MAX_HD = 128                    # FA_MAX_HD in csrc/flash_attention.cu

__all__ = ["flash_attention_cuda", "flash_attention_plain"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [vp] * 4 + [i] * 6 + [
            ctypes.c_float, i, i, i, vp]
        lib.flash_attention_launch.restype = i
        lib._typed = True
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0):
    """Attention on the card.  q: (B, T, H, hd); k, v: (B, S, Hkv, hd), one
    dtype of f32 / bf16, contiguous -> (B, T, H, hd) in q's dtype.  T and S
    take any length; positions start at 0 on both sides.

    Replaces ``src/repro/kernels/flash_attention.py:flash_attention_pallas``.
    Bound on the H100 by operations at prefill lengths: 4 * hd flops per
    valid (query head, q, k) pair, at 989 TFLOP/s in bf16; the kernel runs
    them on the f32 FMA units, so it sits far above that bound.  Design:
    one block per (64-row q tile, q head, batch), K/V tiles of 64 tokens
    in padded shared memory, the online-softmax state in f32 registers,
    and the tiles that the causal or window mask hides entirely skipped.
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
    if window < 0:
        raise ValueError(f"flash_attention_cuda: window {window} < 0")
    B, T, H, hd = q.shape
    Bk, S, Hkv, hd_k = k.shape
    if Bk != B or hd_k != hd or Hkv == 0 or H % Hkv != 0:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k/v {tuple(k.shape)}")
    if not 0 < hd <= MAX_HD:
        raise ValueError(f"flash_attention_cuda: head width {hd} outside "
                         f"1..{MAX_HD}")
    out = torch.empty_like(q)
    if B == 0 or T == 0 or H == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, H, Hkv, hd, 1.0 / math.sqrt(hd), int(causal),
            int(window), _DTYPES[q.dtype], stream)
    _build.check(rc, "flash_attention")
    _build.count_launch("flash_attention")
    return out
