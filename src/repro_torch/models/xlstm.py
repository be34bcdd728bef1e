"""xLSTM, as ``repro.models.xlstm``: mLSTM (matrix memory) and sLSTM
(scalar memory) blocks with stabilised exponential gating, 7:1 in each
group of 8, no separate FFN.

Parameters are a plain dict: ``embed`` (V, D), ``head`` (D, V),
``final_norm`` and ``groups``, a list of ``{"m": [7 mLSTM blocks], "s":
sLSTM block}`` (the reference stacks them on (G, 7) and G for its scans).
The decode state keeps the reference's stacked layout:

  m: C (G, 7, B, H, dh, dh)  n (G, 7, B, H, dh)  m (G, 7, B, H)   f32
  s: c, n, h (G, B, H, dh)   m (G, B, H)                          f32

q/k/v/og stay in the model dtype and the gate math in f32, as in the
reference.  A prompt runs the chunkwise-parallel mLSTM (a loop over chunks
of einsums) where T is a multiple of the chunk, else the step recurrence;
the sLSTM is a loop over time.  Both are plain PyTorch: the reference runs
them outside any Pallas kernel.  The decode step writes the new state into
the state it was given, IN PLACE, and returns it.

On a mesh (``ctx``) the parameters are DTensors, the projections around
the mixers run under DTensor's propagation, and each mixer runs in
``layers.whole_over_model`` (its batch rows, its parameters whole); the
decode state is a tree of DTensors of
``parallel.sharding.cache_spec_tree``'s placements.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import cache_spec_tree
from .common import ModelConfig, remat
from .layers import (_normal, act_spec, constrain, init_norm, on_mesh,
                     prompt_positions, rms_norm, token_nll,
                     whole_over_model)

GROUP = 8          # 7 mLSTM + 1 sLSTM per group
NEG = -1e30        # the stabiliser m of an empty state


def init_mlstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, H, dev = cfg.d_model, cfg.n_heads, gen.device
    s = 1.0 / math.sqrt(d)
    return {"ln": init_norm(d, "rms", dev),
            "wq": _normal(gen, (d, d), s, cfg.dtype),
            "wk": _normal(gen, (d, d), s, cfg.dtype),
            "wv": _normal(gen, (d, d), s, cfg.dtype),
            "wog": _normal(gen, (d, d), s, cfg.dtype),
            "wif": _normal(gen, (d, 2 * H), s, torch.float32),
            "bif": torch.cat([torch.zeros(H, device=dev),
                              torch.full((H,), 3.0, device=dev)]),
            "wout": _normal(gen, (d, d), s, cfg.dtype)}


def init_slstm(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, H, dev = cfg.d_model, cfg.n_heads, gen.device
    dh = d // H
    s, sr = 1.0 / math.sqrt(d), 1.0 / math.sqrt(dh)
    return {"ln": init_norm(d, "rms", dev),
            "wz": _normal(gen, (d, d), s, cfg.dtype),
            "wi": _normal(gen, (d, H), s, torch.float32),
            "wf": _normal(gen, (d, H), s, torch.float32),
            "wo": _normal(gen, (d, d), s, cfg.dtype),
            "rz": _normal(gen, (H, dh, dh), sr, cfg.dtype),
            "ri": _normal(gen, (H, dh, 1), sr, torch.float32),
            "rf": _normal(gen, (H, dh, 1), sr, torch.float32),
            "bf": torch.full((H,), 3.0, device=dev),
            "wout": _normal(gen, (d, d), s, cfg.dtype)}


def mlstm_state(cfg: ModelConfig, B: int, device="cuda", lead=()) -> dict:
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((*lead, B, H, dh, dh), **z),
            "n": torch.zeros((*lead, B, H, dh), **z),
            "m": torch.full((*lead, B, H), NEG, **z)}


def slstm_state(cfg: ModelConfig, B: int, device="cuda", lead=()) -> dict:
    H = cfg.n_heads
    dh = cfg.d_model // H
    z = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((*lead, B, H, dh), **z),
            "n": torch.zeros((*lead, B, H, dh), **z),
            "h": torch.zeros((*lead, B, H, dh), **z),
            "m": torch.full((*lead, B, H), NEG, **z)}


def _mlstm_step(state, q, k, v, ipre, fpre):
    """One recurrence step. q/k/v: (B,H,dh) f32; ipre/fpre: (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    logf = F.logsigmoid(fpre)
    m_new = torch.maximum(logf + m, ipre)
    i_g = torch.exp(ipre - m_new)
    f_g = torch.exp(logf + m - m_new)
    C_new = f_g[..., None, None] * C + \
        i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.maximum(torch.einsum("bhd,bhd->bh", n_new, q).abs(),
                          torch.exp(-m_new))
    h = torch.einsum("bhde,bhe->bhd", C_new, q) / denom[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, h


def mlstm_chunkwise(q, k, v, ipre, fpre, s0, *, chunk: int):
    """Chunkwise-parallel mLSTM, the reference's form: one state carried
    per chunk, the intra-chunk work as einsums, the same stabiliser M and
    the same chunk-end state.  The reference's einsums take bf16 operands
    with f32 accumulation; here every operand is f32, which holds each
    bf16 value exactly.

    q/k/v: (B,T,H,dh);  ipre/fpre: (B,T,H) f32;  s0: {C,n,m}.
    Returns (h (B,T,H,dh) f32, final state)."""
    B, T, H, dh = q.shape
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    nc = T // L

    def to_chunks(x):                      # (B,T,...) -> (nc, B, H, L, ...)
        x = x.float().reshape(B, nc, L, *x.shape[2:])
        if x.dim() == 5:                   # (B,nc,L,H,dh)
            return x.permute(1, 0, 3, 2, 4)
        return x.permute(1, 0, 3, 2)       # gates (B,nc,L,H)->(nc,B,H,L)

    qc, kc, vc = to_chunks(q), to_chunks(k), to_chunks(v)
    ic, fc = to_chunks(ipre), to_chunks(fpre)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))
    C_in, n_in, m_in = s0["C"], s0["n"], s0["m"]
    hs = []
    for c in range(nc):
        qb, kb, vb, ib, fb = qc[c], kc[c], vc[c], ic[c], fc[c]
        F_ = torch.cumsum(F.logsigmoid(fb), dim=-1)         # (B,H,L)
        g = ib - F_
        M = torch.maximum(m_in[..., None], torch.cummax(g, dim=-1).values)
        inter_w = torch.exp(m_in[..., None] - M)            # (B,H,L)
        D = torch.exp(g[..., None, :] - M[..., :, None])    # (B,H,Lq,Ls)
        D = torch.where(causal, D, 0.0)
        scores = torch.einsum("bhld,bhsd->bhls", qb, kb)
        intra = torch.einsum("bhls,bhsd->bhld", scores * D, vb)
        h_num = inter_w[..., None] * torch.einsum(
            "bhde,bhle->bhld", C_in, qb) + intra
        n_j = inter_w[..., None] * n_in[:, :, None, :] + \
            torch.einsum("bhls,bhsd->bhld", D, kb)
        m_j = F_ + M
        denom = torch.maximum(torch.einsum("bhld,bhld->bhl", qb, n_j).abs(),
                              torch.exp(-m_j))
        hs.append(h_num / denom[..., None])
        # ---- chunk-end state ----------------------------------------
        M_L, F_L = M[..., -1], F_[..., -1]
        w = torch.exp(g - M_L[..., None])                   # (B,H,L)
        decay = torch.exp(m_in - M_L)
        C_in = decay[..., None, None] * C_in + \
            torch.einsum("bhs,bhsd,bhse->bhde", w, vb, kb)
        n_in = decay[..., None] * n_in + torch.einsum("bhs,bhsd->bhd", w, kb)
        m_in = F_L + M_L
    # (nc,B,H,L,dh) -> (B,T,H,dh)
    h = torch.stack(hs).permute(1, 0, 3, 2, 4).reshape(B, T, H, dh)
    return h, {"C": C_in, "n": n_in, "m": m_in}


def mlstm_apply(x, p, cfg: ModelConfig, state=None, chunk: int = 128):
    """x: (B,T,D) -> ((B,T,D), final state).  With ``state`` the recurrence
    continues from it (decode, T == 1).  T > 1 takes the chunkwise form
    where T is a multiple of min(chunk, T), else the step recurrence."""
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    xn = rms_norm(x, p["ln"]["scale"])
    # the scale in the model dtype, as the reference multiplies by it
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=cfg.dtype,
                         device=x.device)
    q = (xn @ p["wq"]).reshape(B, T, H, dh) * scale
    k = (xn @ p["wk"]).reshape(B, T, H, dh) * scale
    v = (xn @ p["wv"]).reshape(B, T, H, dh)
    og = torch.sigmoid((xn @ p["wog"]).float()).to(cfg.dtype)
    gates = xn.float() @ p["wif"] + p["bif"]
    ipre, fpre = gates[..., :H], gates[..., H:]
    s = state if state is not None else mlstm_state(cfg, B, x.device)

    if T > 1 and T % min(chunk, T) == 0:
        h, s = mlstm_chunkwise(q, k, v, ipre, fpre, s, chunk=min(chunk, T))
    else:
        q32, k32, v32 = q.float(), k.float(), v.float()
        hs = []
        for t in range(T):
            s, ht = _mlstm_step(s, q32[:, t], k32[:, t], v32[:, t],
                                ipre[:, t], fpre[:, t])
            hs.append(ht)
        h = torch.stack(hs, dim=1)
    out = (h.reshape(B, T, D).to(cfg.dtype) * og) @ p["wout"]
    return out, s


def slstm_apply(x, p, cfg: ModelConfig, state=None):
    """x: (B,T,D) -> ((B,T,D), final state), one step per token.  The
    three recurrent projections of h run as one batched matmul a step."""
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    xn = rms_norm(x, p["ln"]["scale"])
    z_in = (xn @ p["wz"]).reshape(B, T, H, dh).float()
    o_in = (xn @ p["wo"]).reshape(B, T, H, dh).float()
    i_in = xn.float() @ p["wi"]
    f_in = xn.float() @ p["wf"] + p["bf"]
    s = state if state is not None else slstm_state(cfg, B, x.device)
    # (H, dh, dh + 2): rz, ri, rf side by side
    rec = torch.cat([p["rz"].float(), p["ri"], p["rf"]], dim=-1)
    c, n, h, m = s["c"], s["n"], s["h"], s["m"]
    hs = []
    for t in range(T):
        hr = torch.einsum("bhd,hde->bhe", h, rec)
        z = torch.tanh(z_in[:, t] + hr[..., :dh])
        ipre = i_in[:, t] + hr[..., dh]
        fpre = f_in[:, t] + hr[..., dh + 1]
        logf = F.logsigmoid(fpre)
        m_new = torch.maximum(logf + m, ipre)
        i_g = torch.exp(ipre - m_new)[..., None]
        f_g = torch.exp(logf + m - m_new)[..., None]
        c = f_g * c + i_g * z
        n = f_g * n + i_g
        h = torch.sigmoid(o_in[:, t]) * (c / torch.clamp(n, min=1e-6))
        m = m_new
        hs.append(h)
    out = torch.stack(hs, dim=1).reshape(B, T, D).to(cfg.dtype) @ p["wout"]
    return out, {"c": c, "n": n, "h": h, "m": m}


# ------------------------------------------------------------- full model
def init_xlstm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn in a fixed order (embed,
    head, then each block in execution order)."""
    assert cfg.n_layers % GROUP == 0
    d, V, dev = cfg.d_model, cfg.vocab, gen.device
    params = {"embed": _normal(gen, (V, d), 1.0 / math.sqrt(d), cfg.dtype),
              "head": _normal(gen, (d, V), 1.0 / math.sqrt(d), cfg.dtype),
              "final_norm": init_norm(d, "rms", dev)}
    params["groups"] = [
        {"m": [init_mlstm(gen, cfg) for _ in range(GROUP - 1)],
         "s": init_slstm(gen, cfg)}
        for _ in range(cfg.n_layers // GROUP)]
    return params


def xlstm_states(cfg: ModelConfig, B: int, device="cuda", ctx=None) -> dict:
    G = cfg.n_layers // GROUP
    st = {"m": mlstm_state(cfg, B, device, (G, GROUP - 1)),
          "s": slstm_state(cfg, B, device, (G,))}
    return _on_cache_spec(st, ctx)


def _on_cache_spec(st: dict, ctx) -> dict:
    """A state of whole tensors (or of DTensors) with the placements of
    ``cache_spec_tree`` on a mesh; ``st`` itself off it."""
    if not on_mesh(ctx):
        return st
    specs = cache_spec_tree(st, ctx)
    return {part: {k: constrain(v, ctx, specs[part][k])
                   for k, v in st[part].items()} for part in st}


def _mixer(fn, cfg: ModelConfig, ctx):
    """``fn(x, p, cfg, state=...)``, on a mesh in ``whole_over_model``."""
    if not on_mesh(ctx):
        return lambda x, p, state=None: fn(x, p, cfg, state=state)
    return lambda x, p, state=None: whole_over_model(
        lambda x_, p_, st_: fn(x_, p_, cfg, state=st_), ctx, x, p, state)


def _backbone(params, x, cfg: ModelConfig, state=None, collect=False,
              mode: str = "none", ctx=None):
    """The blocks over x (B,T,D), each group under ``remat(mode)``.
    ``state``: continue from it and write the new state into it;
    ``collect``: return the final states, stacked in the reference's
    layout."""

    mlstm, slstm = _mixer(mlstm_apply, cfg, ctx), _mixer(slstm_apply, cfg, ctx)

    def group(h, grp, st):
        ms = []
        for i, blk in enumerate(grp["m"]):
            out, ns = mlstm(h, blk, state=None if st is None
                            else {k: v[i] for k, v in st["m"].items()})
            h = h + out
            ms.append(ns)
        out, ns = slstm(h, grp["s"], state=None if st is None else st["s"])
        return h + out, ms, ns

    group = remat(group, mode)
    ms, ss = [], []
    for g, grp in enumerate(params["groups"]):
        st = None if state is None else {
            part: {k: v[g] for k, v in state[part].items()}
            for part in ("m", "s")}
        x, gm, gs = group(x, grp, st)
        if st is not None:
            for i, ns in enumerate(gm):
                for k in ns:
                    st["m"][k][i].copy_(ns[k])
            for k in gs:
                st["s"][k].copy_(gs[k])
        if collect:
            ms += gm
            ss.append(gs)
    if not collect:
        return x, None
    G = len(params["groups"])
    return x, {"m": {k: torch.stack([s[k] for s in ms]).unflatten(
                   0, (G, GROUP - 1)) for k in ms[0]},
               "s": {k: torch.stack([s[k] for s in ss]) for k in ss[0]}}


def _head(params, x):
    x = rms_norm(x, params["final_norm"]["scale"])
    return (x @ params["head"]).float()


def _embed(params, tokens, ctx=None):
    x = params["embed"][prompt_positions(tokens, params["embed"].device)[0]]
    return constrain(x, ctx, act_spec(ctx))


def xlstm_forward(params, batch, cfg: ModelConfig, ctx=None):
    """Logits (B, T, V).  Each group runs under ``remat``, as the
    reference's scan body does: its ``_remat`` recomputes the whole group
    for "dots" as for "full"."""
    x, _ = _backbone(params, _embed(params, batch["tokens"], ctx), cfg,
                     mode="none" if cfg.remat == "none" else "full",
                     ctx=ctx)
    return _head(params, x)


def xlstm_loss(params, batch, cfg: ModelConfig, ctx=None):
    """Mean next-token NLL over every position (the reference's xLSTM loss
    takes no mask).  On a mesh the logits go whole over ``model`` first
    (``transformer.lm_loss`` says why)."""
    logits = constrain(xlstm_forward(params, batch, cfg, ctx), ctx,
                       act_spec(ctx))
    return token_nll(logits, batch["targets"]).mean()


def xlstm_prefill(params, batch, cfg: ModelConfig, ctx=None):
    """-> (last-token logits (B, V), the decode state)."""
    x, states = _backbone(params, _embed(params, batch["tokens"], ctx), cfg,
                          collect=True, ctx=ctx)
    return _head(params, x[:, -1:])[:, 0], _on_cache_spec(states, ctx)


def xlstm_decode_step(params, state, token, pos, cfg: ModelConfig,
                      ctx=None):
    """One token (B,) -> (logits (B, V), the state updated in place).
    ``pos`` is unused: the recurrence carries the position."""
    token = torch.as_tensor(token, device=params["embed"].device)
    x, _ = _backbone(params, _embed(params, token[:, None], ctx), cfg,
                     state=state, ctx=ctx)
    return _head(params, x)[:, 0], state
