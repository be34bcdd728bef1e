"""Model primitives the paged serving path needs, as in
``repro.models.layers``: norms, RoPE, the MLP, and parameter init.

Parameter layout follows the reference, so converted JAX parameters drop
in unchanged:

  attn:  wq (D, H*hd)   wk/wv (D, Hkv*hd)   wo (H*hd, D)   [+ bq/bk/bv]
  mlp:   wg/wu (D, F)   wd (F, D)           (gelu: wi (D, F), wd)

Init draws from an explicit ``torch.Generator`` with ``init_lm``'s
distributions; parameters land on the generator's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


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
