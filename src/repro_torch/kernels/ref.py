"""Plain PyTorch twins of ``repro.kernels.ref``: the ground truth every
kernel of the port is held against.  Same signatures, same layouts, same
f32 arithmetic; inputs and outputs are tensors on any device."""
from __future__ import annotations

import math

import torch

ADLER_MOD = 65521


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        q_offset: int = 0):
    """q: (B, T, H, hd); k, v: (B, S, Hkv, hd) -> (B, T, H, hd). f32 math.
    Query row t sits at position ``q_offset + t``, key s at s."""
    B, T, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_rep = H // Hkv
    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    valid = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (k_pos <= q_pos)
    if window:
        valid = valid & (q_pos - k_pos < window)
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))
    out = torch.einsum("bhts,bshd->bthd", p, v.float())
    return out.to(q.dtype)


def paged_attention_ref(q, k_pool, v_pool, block_table, seq_lens, *,
                        return_lse: bool = False):
    """q: (B, H, hd); pools: (P, page, Hkv, hd); block_table: (B, max_pages);
    seq_lens: (B,) -> (B, H, hd), and with ``return_lse`` each row's
    log-sum-exp of its scaled scores (B, H) f32 (-inf at length 0, where
    the output is 0)."""
    B, H, hd = q.shape
    P, page, Hkv, _ = k_pool.shape
    n_rep = H // Hkv
    max_pages = block_table.shape[1]
    scale = 1.0 / math.sqrt(hd)
    tbl = block_table.long()
    k = k_pool[tbl].reshape(B, max_pages * page, Hkv, hd)
    v = v_pool[tbl].reshape(B, max_pages * page, Hkv, hd)
    k = k.repeat_interleave(n_rep, dim=2).float()
    v = v.repeat_interleave(n_rep, dim=2).float()
    s = torch.einsum("bhd,bshd->bhs", q.float(), k) * scale
    tok = torch.arange(max_pages * page, device=q.device)[None, :]
    valid = (tok < seq_lens.to(q.device).long()[:, None])[:, None, :]
    s = s.masked_fill(~valid, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid, p, torch.zeros((), device=q.device))
    out = torch.einsum("bhs,bshd->bhd", p, v).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def gather_quantize_ref(pool, page_ids, eps: float = 1e-12):
    """pool: (P, page, F) -> (q (n, page, F) int8, scales (n, page) f32).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.  127 is
    divided by as a tensor: on CUDA, PyTorch turns a division by a Python
    number into a multiply by its reciprocal, which moves the last bit of
    some scales; the JAX oracle and the kernel divide."""
    x = pool[page_ids.long()].float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0) + eps
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def scatter_dequantize_ref(pool, page_ids, q, scales):
    """Functional, like the JAX oracle: returns a new pool with the
    dequantized pages written at ``page_ids``."""
    x = q.float() * scales[..., None]
    out = pool.clone()
    out[page_ids.long()] = x.to(pool.dtype)
    return out


def transit_crc_ref(q):
    """Per-page Adler-32 of the packed int8 payload (row-major
    two's-complement bytes), exact int64 math: bit-identical to
    ``zlib.adler32(page.tobytes())``.  q: (n, page, F) int8 -> (n,) int64
    holding the uint32 value."""
    n_pages = q.shape[0]
    d = q.reshape(n_pages, -1).view(torch.uint8).long()
    n = d.shape[1]
    w = torch.arange(n, 0, -1, dtype=torch.int64, device=q.device)
    s2 = ((d * w).sum(dim=1) + n) % ADLER_MOD
    s1 = (1 + d.sum(dim=1)) % ADLER_MOD
    return (s2 << 16) | s1
