"""The yardstick's arithmetic: the H100's published peaks, the least time
the card could take for some work, and the operations and bytes of each
kernel launch and model call, all from shapes.

``bound`` and ``flash_pairs`` are frozen copies of ``chip_smoke.py``'s
(``bound`` returns ms, as there).  The counts follow what the work needs,
not what a kernel happens to read: each input byte read once, each output
byte written once, the (query, key) pairs the causal mask keeps.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
F32_OPS_PER_S = 67e12            # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense


# copied from chip_smoke.py ``bound``
def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# copied from chip_smoke.py ``flash_pairs``
def flash_pairs(T: int, S: int, causal: bool, window: int) -> int:
    """The (q, k) pairs the mask keeps: the work this input needs."""
    qp = np.arange(T)
    hi = np.minimum(qp + 1, S) if causal else np.full(T, S)
    lo = np.maximum(qp - window + 1, 0) if window else np.zeros(T, int)
    return int(np.maximum(hi - lo, 0).sum())


def flash_work(B: int, T: int, S: int, H: int, Hkv: int, hd: int, *,
               causal: bool = True, window: int = 0,
               itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one flash-attention launch: q.k and p.v over
    the kept pairs (2 operations a multiply-add each), q, k and v read
    once and the output written once."""
    pairs = B * flash_pairs(T, S, causal, window)
    ops = 4.0 * pairs * H * hd
    n_bytes = (2 * B * T * H * hd + 2 * B * S * Hkv * hd) * itemsize
    return ops, float(n_bytes)


def paged_work(lens, H: int, Hkv: int, hd: int,
               itemsize: int = 2) -> tuple[float, float]:
    """(operations, bytes) of one paged-attention call (its partition and
    combine launches) over sequences of ``lens`` tokens: the K and V rows
    of each sequence's length read once, q read and the output written."""
    n = float(np.sum(lens))
    B = len(lens)
    ops = 4.0 * n * H * hd
    n_bytes = (2.0 * n * Hkv * hd + 2.0 * B * H * hd) * itemsize
    return ops, n_bytes


def matmul_params(d: int, H: int, Hkv: int, hd: int, f: int) -> int:
    """Weights of one dense block's products: q, k, v, o and a SwiGLU MLP."""
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d + 3 * d * f


def prefill_flops(T: int, *, L: int, d: int, H: int, Hkv: int, hd: int,
                  f: int, V: int) -> float:
    """Model FLOPs of one prompt's prefill: every block's products over T
    tokens, causal attention, and the logits of the last token."""
    per_layer = 2.0 * matmul_params(d, H, Hkv, hd, f) * T \
        + 4.0 * H * hd * flash_pairs(T, T, True, 0)
    return L * per_layer + 2.0 * d * V


def decode_flops(lens, *, L: int, d: int, H: int, Hkv: int, hd: int,
                 f: int, V: int) -> float:
    """Model FLOPs of one decode step: a token for each sequence, which
    attends over ``lens`` tokens (its own included), and its logits."""
    B = len(lens)
    per_layer = 2.0 * matmul_params(d, H, Hkv, hd, f) * B \
        + 4.0 * H * hd * float(np.sum(lens))
    return L * per_layer + 2.0 * d * V * B
