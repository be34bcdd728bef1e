"""Model primitives, as in ``repro.models.layers`` without a mesh: norms,
RoPE and sinusoidal positions, the projections, decode attention over a
contiguous cache on the paged kernel, the MLP, the capacity-routed MoE
block, and parameter init.  Attention over a prompt is the flash kernel's
(``kernels.ops.flash_attention``), whose plain version is the CPU's.

Parameter layout follows the reference, so converted JAX parameters drop
in unchanged:

  attn:  wq (D, H*hd)   wk/wv (D, Hkv*hd)   wo (H*hd, D)   [+ bq/bk/bv]
  mlp:   wg/wu (D, F)   wd (F, D)           (gelu: wi (D, F), wd)
  moe:   router (D, E)  wg/wu (E, D, F)     wd (E, F, D)

Init draws from an explicit ``torch.Generator`` with ``init_lm``'s
distributions; parameters land on the generator's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import paged_attention
from repro_torch.kernels.paged_attention import MAX_REP


# --------------------------------------------------------------------- norms
def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale)).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    return (((x32 - mu) * torch.rsqrt(var + eps)) * scale + bias).to(x.dtype)


def apply_norm(x, p, kind: str):
    if kind == "ln":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def init_norm(d: int, kind: str, device="cuda"):
    if kind == "ln":
        return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
                "bias": torch.zeros((d,), dtype=torch.float32, device=device)}
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


# ---------------------------------------------------------------------- RoPE
def rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: broadcastable to (..., T).  Half-split
    rotation (first half against second half), not interleaved."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs                       # (..., T, half)
    cos = torch.cos(ang)[..., None, :]                                # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pos(positions, d: int, dtype):
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ------------------------------------------------------ prompts and the loss
def prompt_positions(tokens, device):
    """Tokens (B, T) as int64 on ``device``, and positions 0..T-1 (B, T)."""
    tokens = torch.as_tensor(tokens, device=device).long()
    B, T = tokens.shape
    return tokens, torch.arange(T, device=device)[None].expand(B, T)


def token_nll(logits, targets):
    """The next-token NLL at every position: logits (B, T, V), targets
    (B, T) -> (B, T)."""
    targets = torch.as_tensor(targets, device=logits.device).long()
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def check_decode_positions(pos, filled, S: int, ring: bool) -> None:
    """Before a decode step writes anything: ``pos`` (B,) the step's
    positions, ``filled`` (B,) each row's count of valid slots, both on
    the device and read in one transfer a step.  Raises IndexError on a
    position below 0, or at or past S where the cache is no ring (the
    reference drops such a write, ROADMAP Queue 3 item 2), and ValueError
    where a row does not hold exactly its positions before pos, min(pos,
    S) of them in a ring: past them the paged kernel would read
    never-written slots that the reference masks out."""
    want, have = torch.stack([pos, filled]).tolist()
    if min(want) < 0 or (not ring and max(want) >= S):
        raise IndexError(f"decode at positions {min(want)}..{max(want)} "
                         f"of a cache of {S} slots")
    if [min(p, S) for p in want] != have:
        raise ValueError(f"decode at positions {want} over rows holding "
                         f"{have} tokens: each row's step goes in the slot "
                         f"after its last")


# ------------------------------------------- decode over a contiguous cache
def contiguous_page(S: int) -> int:
    """The page a contiguous cache of S slots is viewed in: the largest of
    16, 8, 4, 2 and 1 that divides S (1500 frames: 4; 144 slots: 16)."""
    return next(p for p in (16, 8, 4, 2, 1) if S % p == 0)


def kernel_rep(n_rep: int) -> int:
    """Query heads per kv head in one row of the paged kernel: the largest
    divisor of n_rep up to the kernel's ``MAX_REP``."""
    return max(r for r in range(1, min(n_rep, MAX_REP) + 1) if n_rep % r == 0)


@dataclass(frozen=True)
class DecodePages:
    """One decode step's view of a contiguous (B, S, Hkv, hd) cache layer
    as a pool of B * S / page pages of the paged kernel: an identity block
    table and each row's length, built once a step on the cache's device
    and shared by every layer.  A row with n_rep above ``MAX_REP`` is
    ``split`` rows of ``n_rep / split`` query heads each (its table row
    and length repeated), so the kernel runs at its own n_rep and reads
    each page ``split`` times."""
    page: int
    table: torch.Tensor        # (B * split, S / page) int32
    lens: torch.Tensor         # (B * split,) int32
    split: int


def decode_pages(lens, S: int, n_rep: int) -> DecodePages:
    """lens: (B,) the valid slots of each row, which are slots 0..len-1:
    ``pos + 1`` for self-attention (prefill fills 0..T-1, each decode step
    slot ``pos``), ``min(pos + 1, S)`` over a windowed ring of S slots, S
    for cross-attention."""
    B, page = lens.shape[0], contiguous_page(S)
    split = n_rep // kernel_rep(n_rep)
    table = torch.arange(B * (S // page), dtype=torch.int32,
                         device=lens.device).view(B, S // page)
    lens = lens.to(torch.int32)
    if split > 1:
        table = table.repeat_interleave(split, dim=0)
        lens = lens.repeat_interleave(split)
    return DecodePages(page, table, lens, split)


def paged_view(q, k, v, pages: DecodePages):
    """The paged kernel's inputs for one query token against a contiguous
    cache: q (B, 1, H, hd) as (B * split, H / split, hd), each row's
    heads those of ``n_rep / split`` query heads of every kv head; k, v
    (B, S, Hkv, hd), contiguous, as pools (B * S / page, page, Hkv, hd)."""
    B, _, H, hd = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    n_pool = B * S // pages.page
    split, r = pages.split, H // Hkv // pages.split
    qv = q.reshape(B, Hkv, split, r, hd).transpose(1, 2) \
        .reshape(B * split, Hkv * r, hd)
    return (qv, k.view(n_pool, pages.page, Hkv, hd),
            v.view(n_pool, pages.page, Hkv, hd))


def decode_attention(q, k, v, pages: DecodePages):
    """One query token against a contiguous cache on the paged kernel
    (``kernels.ops.paged_attention``: the kernel on the card, its plain
    version on the CPU).  q: (B, 1, H, hd); k, v: (B, S, Hkv, hd),
    contiguous -> (B, 1, H, hd).  Equals the reference's off-mesh
    ``decode_attention`` (non-windowed) where the valid slots of row b are
    exactly 0..len_b-1."""
    B, _, H, hd = q.shape
    Hkv = k.shape[2]
    split, r = pages.split, H // Hkv // pages.split
    out = paged_attention(*paged_view(q, k, v, pages), pages.table,
                          pages.lens)
    return out.view(B, split, Hkv, r, hd).transpose(1, 2) \
        .reshape(B, 1, H, hd)


def decode_update_and_attend(q, cache_k, cache_v, cache_pos, new_k, new_v,
                             slot, pages: DecodePages, pos=None):
    """Write the new token's K/V into one layer's cache at ``slot`` = (rows
    (B,), slot index (B,)), one batched indexed write each, IN PLACE (the
    reference returns new arrays), and its position ``pos`` (B,) into
    ``cache_pos`` (default: the slot index, which is the position in a
    cache that is not a ring), then attend over the cache.  A windowed
    ring of S slots writes slot pos % S and attends with lengths
    min(pos + 1, S): its valid slots are always 0..min(pos, S - 1), and
    the softmax does not depend on their order.
    q: (B, 1, H, hd); cache_k/v: (B, S, Hkv, hd); cache_pos: (B, S);
    new_k/v: (B, 1, Hkv, hd) -> attn_out (B, 1, H, hd)."""
    cache_k[slot] = new_k[:, 0].to(cache_k.dtype)
    cache_v[slot] = new_v[:, 0].to(cache_v.dtype)
    cache_pos[slot] = (slot[1] if pos is None else pos).to(cache_pos.dtype)
    return decode_attention(q, cache_k, cache_v, pages)


# ---------------------------------------------------------------- MLP blocks
def silu(x):
    """x * sigmoid(x), one op at a time: in bf16 each step rounds where the
    reference's lowering of ``jax.nn.silu`` rounds (a fused ``F.silu``
    rounds once, and bf16 logits drift a unit apart per layer)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def mlp_apply(x, p, act: str):
    if act == "swiglu":
        h = silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = F.gelu(x @ p["wi"], approximate="tanh")
    return h @ p["wd"]


def _normal(gen: torch.Generator, shape, std: float, dtype):
    return (torch.randn(shape, generator=gen, device=gen.device) * std
            ).to(dtype)


def mlp_init(gen: torch.Generator, d: int, f: int, act: str, dtype):
    s_in = 1.0 / math.sqrt(d)
    s_out = 1.0 / math.sqrt(f)
    if act == "swiglu":
        return {"wg": _normal(gen, (d, f), s_in, dtype),
                "wu": _normal(gen, (d, f), s_in, dtype),
                "wd": _normal(gen, (f, d), s_out, dtype)}
    return {"wi": _normal(gen, (d, f), s_in, dtype),
            "wd": _normal(gen, (f, d), s_out, dtype)}


# ----------------------------------------------------------------------- MoE
def capacity_top_k(score, capacity: int):
    """``jax.lax.top_k`` over the last axis: the ``capacity`` largest,
    descending, and of equal values the lower index first (a stable sort;
    ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :capacity], idx[..., :capacity]


def moe_local(x, router, wg, wu, wd, *, top_k: int, capacity: int):
    """Token-choice routing with per-expert top-C capacity over the
    scores, the experts' SwiGLU on the gathered tokens, then a scatter-add.
    x: (T, D); wg/wu: (E, D, F); wd: (E, F, D) -> (T, D), every expert
    local (the reference's ``expert_offset`` 0).  Tokens an expert does
    not route score 0; where C exceeds the routed count, the zero-gate
    tokens picked add exactly nothing."""
    T, D = x.shape
    E = wg.shape[0]
    logits = (x @ router.to(x.dtype)).float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)                  # (T, k)
    topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)
    hit = topi[:, :, None] == torch.arange(E, device=x.device)     # (T, k, E)
    score = torch.where(hit, topw[:, :, None], 0.0).sum(dim=1)     # (T, E)
    gate, idx = capacity_top_k(score.T, capacity)                  # (E, C)
    xe = x[idx]                                                    # (E, C, D)
    h = silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)
    ye = ye * gate[..., None].to(ye.dtype)
    return torch.zeros((T, D), dtype=ye.dtype, device=x.device).index_add_(
        0, idx.reshape(-1), ye.reshape(-1, D))


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(n_tokens * top_k / n_experts * cf))
    c = max(c, min(4, n_tokens))       # decode floor: tiny T, skewed routing
    return max(1, min(n_tokens, c))


def moe_apply(x, p, moe_cfg):
    """x: (B, T, D), every expert local (the reference without a mesh)."""
    B, T, D = x.shape
    E, k, cf = moe_cfg.n_experts, moe_cfg.top_k, moe_cfg.capacity_factor
    out = moe_local(x.reshape(-1, D), p["router"], p["wg"], p["wu"], p["wd"],
                    top_k=k, capacity=moe_capacity(B * T, k, E, cf))
    return out.reshape(B, T, D)


def moe_init(gen: torch.Generator, d: int, moe_cfg, dtype):
    E, F_ = moe_cfg.n_experts, moe_cfg.d_expert
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(F_)
    return {"router": _normal(gen, (d, E), s_in, torch.float32),
            "wg": _normal(gen, (E, d, F_), s_in, dtype),
            "wu": _normal(gen, (E, d, F_), s_in, dtype),
            "wd": _normal(gen, (E, F_, d), s_out, dtype)}


# ------------------------------------------------------------ attn (proj) ---
def attn_init(gen: torch.Generator, d: int, n_heads: int, n_kv: int, hd: int,
              bias: bool, dtype):
    s = 1.0 / math.sqrt(d)
    p = {"wq": _normal(gen, (d, n_heads * hd), s, dtype),
         "wk": _normal(gen, (d, n_kv * hd), s, dtype),
         "wv": _normal(gen, (d, n_kv * hd), s, dtype),
         "wo": _normal(gen, (n_heads * hd, d), 1.0 / math.sqrt(n_heads * hd),
                       dtype)}
    if bias:
        dev = gen.device
        p["bq"] = torch.zeros((n_heads * hd,), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((n_kv * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((n_kv * hd,), dtype=dtype, device=dev)
    return p


def qkv_proj(x, p, n_heads: int, n_kv: int, hd: int):
    B, T, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(B, T, n_heads, hd), k.reshape(B, T, n_kv, hd),
            v.reshape(B, T, n_kv, hd))


def out_proj(attn_out, p):
    B, T = attn_out.shape[:2]
    return attn_out.reshape(B, T, -1) @ p["wo"]
