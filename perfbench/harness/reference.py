"""The plain reference: the dense decoder of a configuration file in
float32, written from the model's description with ``torch`` operations
alone, with no kernel, cache or batching, and nothing of the program.

Per block: RMSNorm (x / rms(x) times 1 + scale), q, k and v products,
rotary positions (half-split, ``rope_theta``), causal attention with
grouped K/V heads, the output product, the residual; RMSNorm, the SwiGLU
MLP (silu(x Wg) * (x Wu)) Wd, the residual.  Then RMSNorm and the head.

A session that was suspended had the K/V rows it held at that moment
packed to int8 and back (the program's page-out and page-in); queries
after the resume see those rows so.  ``int8_round_trip`` is that
arithmetic, copied from ``repro_torch/kernels/ref.py``
(``gather_quantize_ref``, then ``q * scale``): per row (one token of one
layer's K or V, all heads), scale = absmax / 127 + 1e-12, round half to
even, clamp to 127; the rows are held in the pool's type (the
configuration's bfloat16) before the packing and after the unpacking.

``lowp=True`` is the control: the same model with the inputs of every
product (weights per tensor, activations per row) and the K/V rows
rounded to float8 e4m3 with an absmax scale, the precision next below the
configuration's bfloat16.
"""
from __future__ import annotations

import math

import torch

from .weights import dims

EPS_INT8 = 1e-12
FP8_MAX = 448.0             # largest float8_e4m3fn
Q_ROWS = 1024               # query rows a block of the attention takes


def int8_round_trip(x, store=torch.bfloat16):
    """x (..., F) f32 -> the rows as a page-out and page-in leave them:
    held in the pool's type, packed to int8 by row, unpacked into the
    pool's type again."""
    x = x.to(store).float()
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax / torch.full_like(amax, 127.0) + EPS_INT8
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return (q * scale).to(store).float()


def fp8_round_trip(x, per_row: bool):
    """x f32 rounded to float8 e4m3 with an absmax scale, per row or per
    tensor, and back to f32."""
    amax = x.abs().amax(dim=-1, keepdim=True) if per_row else x.abs().amax()
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    def __init__(self, config: dict, weights: dict, *, lowp: bool = False):
        self.m = dims(config)
        self.eps = float(config["rms_norm_eps"])
        self.theta = float(config["rope_theta"])
        self.w = weights
        self.lowp = lowp

    def _mat(self, w):
        w = w.float()
        return fp8_round_trip(w, per_row=False) if self.lowp else w

    def _act(self, x):
        return fp8_round_trip(x, per_row=True) if self.lowp else x

    def _norm(self, x, scale):
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * (1.0 + scale.float())

    def _rope(self, x, pos):
        """x (T, heads, hd), pos (T,)."""
        half = x.shape[-1] // 2
        freqs = torch.exp(-math.log(self.theta) * torch.arange(
            half, dtype=torch.float32, device=x.device) / half)
        ang = pos[:, None].float() * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def _attend(self, q, k, v, q0: int):
        """Queries q (n, H, hd) at positions q0.., keys k, v (S, Hkv, hd)
        at 0..; causal."""
        m = self.m
        rep = m["H"] // m["Hkv"]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(m["hd"])
        qp = q0 + torch.arange(q.shape[0], device=q.device)[:, None]
        kp = torch.arange(k.shape[0], device=q.device)[None, :]
        s = s.masked_fill(kp > qp, -math.inf)
        return torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v)

    def _attention(self, q, k, v, packed: list[int]):
        """Causal attention over the whole sequence; the queries from each
        resume on see the rows before it through the int8 round trip."""
        T = q.shape[0]
        cuts = [0] + sorted(c for c in packed if 0 < c < T) + [T]
        out = torch.empty_like(q)
        for a, b in zip(cuts[:-1], cuts[1:]):
            ks, vs = k[:b], v[:b]
            if a > 0:
                ks = torch.cat([int8_round_trip(k[:a].flatten(1))
                                .view_as(k[:a]), k[a:b]])
                vs = torch.cat([int8_round_trip(v[:a].flatten(1))
                                .view_as(v[:a]), v[a:b]])
            for r in range(a, b, Q_ROWS):
                e = min(r + Q_ROWS, b)
                out[r:e] = self._attend(q[r:e], ks[:e], vs[:e], r)
        return out

    @torch.no_grad()
    def logits(self, tokens, first: int, packed=()) -> torch.Tensor:
        """Logits (f32) at positions ``first``..T-1 of ``tokens`` (each
        predicting the next token); ``packed`` lists the K/V lengths at
        which the session was suspended."""
        m, w = self.m, self.w
        dev = w["embed"].device
        tok = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        T = tok.shape[0]
        pos = torch.arange(T, device=dev)
        x = w["embed"][tok].float()
        for blk in w["blocks"]:
            a = blk["attn"]
            h = self._act(self._norm(x, blk["ln1"]["scale"]))
            q = (h @ self._mat(a["wq"])).view(T, m["H"], m["hd"])
            k = (h @ self._mat(a["wk"])).view(T, m["Hkv"], m["hd"])
            v = (h @ self._mat(a["wv"])).view(T, m["Hkv"], m["hd"])
            q, k = self._rope(q, pos), self._rope(k, pos)
            k = self._act(k.flatten(1)).view_as(k)
            v = self._act(v.flatten(1)).view_as(v)
            att = self._attention(q, k, v, list(packed)).reshape(T, -1)
            x = x + self._act(att) @ self._mat(a["wo"])
            h = self._act(self._norm(x, blk["ln2"]["scale"]))
            p = blk["mlp"]
            g = h @ self._mat(p["wg"])
            u = self._act(g * torch.sigmoid(g) * (h @ self._mat(p["wu"])))
            x = x + u @ self._mat(p["wd"])
        x = self._norm(x[first:], w["final_norm"]["scale"])
        return self._act(x) @ self._mat(w["head"])
