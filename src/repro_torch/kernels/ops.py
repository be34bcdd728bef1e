"""Public kernel API: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version.  There is no fallback: a
CUDA call that the kernel refuses raises, and any other device raises.

The torch counterpart of ``repro/kernels/ops.py``'s TPU / interpret switch.
"""
from __future__ import annotations

import torch

from .block_transit import (gather_quantize_crc_plain, gather_quantize_cuda,
                            gather_quantize_plain, one_slot,
                            scatter_dequantize_crc_plain,
                            scatter_dequantize_cuda, scatter_dequantize_plain)
from .flash_attention import flash_attention_cuda, flash_attention_plain
from .paged_attention import paged_attention_cuda, paged_attention_plain

__all__ = ["flash_attention", "paged_attention", "gather_quantize",
           "scatter_dequantize", "gather_quantize_crc",
           "scatter_dequantize_crc", "gather_quantize_crc_units",
           "scatter_dequantize_crc_units"]


def _on_card(t) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


class _FlashAttention(torch.autograd.Function):
    """The forward on the kernel (CUDA) or the plain version (CPU); the
    backward recomputes through the plain version, as the reference's
    ``_flash_bwd`` does through its oracle: no backward kernel exists."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.args = dict(causal=causal, window=window, q_offset=q_offset)
        if _on_card(q):
            return flash_attention_cuda(q, k, v, **ctx.args)
        return flash_attention_plain(q, k, v, **ctx.args)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = flash_attention_plain(q, k, v, **ctx.args)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: (B, T, H, hd); k, v: (B, S, Hkv, hd) -> (B, T, H, hd), with a
    gradient with respect to q, k and v.  Query row t sits at position
    ``q_offset + t`` (a shard of the query rows), key s at s."""
    return _FlashAttention.apply(q, k, v, causal, window, q_offset)


def paged_attention(q, k_pool, v_pool, block_table, seq_lens, *,
                    return_lse: bool = False):
    """q: (B, H, hd); pools: (P, page, Hkv, hd); block_table: (B, max_pages)
    int32; seq_lens: (B,) int32 -> (B, H, hd), and with ``return_lse``
    each row's log-sum-exp (B, H) f32 (-inf at length 0)."""
    if _on_card(q):
        return paged_attention_cuda(q, k_pool, v_pool, block_table, seq_lens,
                                    return_lse=return_lse)
    return paged_attention_plain(q, k_pool, v_pool, block_table, seq_lens,
                                 return_lse=return_lse)


def gather_quantize_crc_units(stack, units):
    """Fused spill codec over a batch: stack (S, P, page, F), units (n, 2)
    int32 (slot, page) -> (q (n, page, F) int8, scales (n, page) f32,
    crcs (n,) int64 Adler-32), in one pass."""
    if _on_card(stack):
        return gather_quantize_cuda(stack, units)
    return gather_quantize_crc_plain(stack, units)


def scatter_dequantize_crc_units(stack, units, q, scales):
    """Fused restore codec over a batch, in place -> (stack, crcs of each
    unit's payload as received), in one pass."""
    if _on_card(stack):
        return scatter_dequantize_cuda(stack, units, q, scales)
    return scatter_dequantize_crc_plain(stack, units, q, scales)


# The one-pool API of the reference: a pool (P, page, F) and page ids (n,),
# through the same codec as a stack of one slot.
def gather_quantize(pool, page_ids):
    """pool (P, page, F); page_ids (n,) int32 -> (q int8, scales f32)."""
    if _on_card(pool):
        return gather_quantize_cuda(*one_slot(pool, page_ids),
                                    with_crc=False)
    return gather_quantize_plain(*one_slot(pool, page_ids))


def scatter_dequantize(pool, page_ids, q, scales):
    """Writes the dequantized pages into ``pool`` in place; returns it."""
    if _on_card(pool):
        scatter_dequantize_cuda(*one_slot(pool, page_ids), q, scales,
                                with_crc=False)
    else:
        scatter_dequantize_plain(*one_slot(pool, page_ids), q, scales)
    return pool


def gather_quantize_crc(pool, page_ids):
    """Fused spill codec -> (q int8, scales f32, crcs int64 Adler-32)."""
    return gather_quantize_crc_units(*one_slot(pool, page_ids))


def scatter_dequantize_crc(pool, page_ids, q, scales):
    """Fused restore codec, in place -> (pool, crcs of the payload as
    received)."""
    return pool, scatter_dequantize_crc_units(
        *one_slot(pool, page_ids), q, scales)[1]
