"""RecurrentGemma / Griffin hybrid, as ``repro.models.rglru``: RG-LRU
recurrent blocks and local sliding-window attention in a (rec, rec, attn)
pattern; 38 layers = 12 groups of 3 + 2 trailing recurrent layers.

The RG-LRU is a gated linear recurrence
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(lam) * r_t),  r_t, i_t = sigmoid(linear(x_t)),
evaluated over a prompt as a log-depth doubling scan over T (the same
O(T log T) as the reference's ``jax.lax.associative_scan``) and as one
step in decode.  Plain PyTorch: the reference runs it outside any Pallas
kernel.

Parameters are a plain dict: ``embed``, ``head``, ``final_norm``,
``groups``, a list of ``{"rec1", "rec2", "attn"}`` layers (the reference
stacks them on G for its scan), and ``tail{t}`` for the trailing
recurrent layers.  The decode state keeps the reference's layout:
``groups`` = {``rec1``, ``rec2``: {h (G, B, R) f32, tail (G, B, 3, R)},
``attn``: {k, v (G, B, W, Hkv, hd), pos (G, B, W) int32}} and
``tail{t}`` = {h (B, R), tail (B, 3, R)}.

The attention ring always has W slots: position p sits in slot p % W and
a slot not yet written has pos -1 (the reference's ``rg_states`` rule; its
prefill keeps only min(T, W) slots, ROADMAP Queue 3).  Prompt attention
runs the flash kernel with the window, decode attention the paged kernel
over the ring viewed as pages (``layers.decode_attention``), the valid
slots of a row being 0..min(pos, W - 1).  The decode step writes the new
state IN PLACE and returns it.

On a mesh (``ctx``) the parameters are DTensors: the recurrent mixer
runs sharded over its channels (``rec_mixer_mesh``; whole on every rank
of ``model``, ``layers.whole_over_model``, where R does not divide it),
the attention in
``layers.mesh_attention`` and, in decode, ``layers.mesh_decode_attend``
over the ring sharded on W; the state is a tree of DTensors of
``parallel.sharding.cache_spec_tree``'s placements.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import flash_attention
from repro_torch.parallel.sharding import cache_spec_tree, filled_tree
from .common import ModelConfig, remat
from .layers import (_local, _normal, act_spec, attn_init,
                     check_decode_positions,
                     constrain, decode_pages, decode_update_and_attend,
                     embed, fill_cache_shard, init_norm, mesh_attention,
                     mesh_decode, mesh_decode_attend, mlp_apply, mlp_init,
                     model_shard, ModelShard, on_mesh, out_proj,
                     prompt_positions, qkv_proj, rms_norm, rope, token_nll,
                     whole_over_model)

PATTERN = ("rec", "rec", "attn")
GROUP_KEYS = ("rec1", "rec2", "attn")    # a group's layers, by PATTERN
_C = 8.0                      # RG-LRU gate sharpness constant (Griffin)
CONV_W = 4


def init_rec_mixer(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dev = cfg.d_model, gen.device
    R = cfg.lru_width or d
    s, sR = 1.0 / math.sqrt(d), 1.0 / math.sqrt(R)
    target = torch.linspace(0.9, 0.999, R, device=dev)
    return {"ln": init_norm(d, "rms", dev),
            "w_gate": _normal(gen, (d, R), s, cfg.dtype),
            "w_x": _normal(gen, (d, R), s, cfg.dtype),
            "conv_w": _normal(gen, (CONV_W, R), 0.1, cfg.dtype),
            "conv_b": torch.zeros((R,), dtype=cfg.dtype, device=dev),
            "w_r": _normal(gen, (R, R), sR, cfg.dtype),
            "w_i": _normal(gen, (R, R), sR, cfg.dtype),
            # softplus^-1 of the target decay
            "lam": torch.log(torch.expm1(-torch.log(target) / _C)),
            "w_out": _normal(gen, (R, d), sR, cfg.dtype)}


def init_rg_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    dev = gen.device
    if kind == "rec":
        p = {"rec": init_rec_mixer(gen, cfg)}
    else:
        p = {"ln1": init_norm(cfg.d_model, "rms", dev),
             "attn": attn_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, False, cfg.dtype)}
    p["ln2"] = init_norm(cfg.d_model, "rms", dev)
    p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, cfg.dtype)
    return p


def _causal_conv(x, w, b, tail=None):
    """Depthwise causal conv, width 4. x: (B,T,R). tail: (B,3,R) history.
    The taps are summed in the reference's order."""
    pad = (torch.zeros_like(x[:, :CONV_W - 1]) if tail is None
           else tail.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    n = xp.shape[1]
    out = 0
    for j in range(CONV_W):
        out = out + xp[:, CONV_W - 1 - j:n - j] * w[CONV_W - 1 - j]
    return out + b, xp[:, -(CONV_W - 1):]


def linear_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0, as a
    Hillis-Steele doubling scan: log2(T) steps, each combining every
    element with the one d before it, (a1, b1) then (a2, b2) -> (a1 a2,
    a2 b1 + b2), the reference's combine."""
    d, T = 1, a.shape[1]
    while d < T:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                               b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rg_lru(y, p, h0=None, y_in=None):
    """y: (B,T,R) conv output. Returns (out (B,T,R) f32, h_last (B,R)).
    ``y_in``: what the r and i gates' products read (default y); on a mesh
    y is this rank's channels and ``y_in`` all of them."""
    y32 = y.float()
    y_in = y if y_in is None else y_in
    r = torch.sigmoid(y_in @ p["w_r"]).float()
    i = torch.sigmoid(y_in @ p["w_i"]).float()
    log_a = -_C * F.softplus(p["lam"]) * r                 # (B,T,R), <= 0
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * y32)
    if y.shape[1] == 1 and h0 is not None:                 # decode fast path
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None], h
    if h0 is not None:
        # fold the carry-in into the first element
        gated = torch.cat([gated[:, :1] + (a[:, 0] * h0)[:, None],
                           gated[:, 1:]], dim=1)
    hh = linear_scan(a, gated)
    return hh, hh[:, -1]


def rec_mixer_apply(x, p, cfg: ModelConfig, state=None):
    """state: {'h': (B,R), 'tail': (B,3,R)} or None."""
    xn = rms_norm(x, p["ln"]["scale"])
    gate = F.gelu((xn @ p["w_gate"]).float(), approximate="tanh")
    y = xn @ p["w_x"]
    y, new_tail = _causal_conv(y, p["conv_w"], p["conv_b"],
                               None if state is None else state["tail"])
    h, h_last = rg_lru(y, p, None if state is None else state["h"])
    out = (h * gate).to(cfg.dtype) @ p["w_out"]
    return out, {"h": h_last, "tail": new_tail.to(cfg.dtype)}


def rec_mixer_mesh(x, p, cfg: ModelConfig, state, ctx, sh: ModelShard):
    """``rec_mixer_apply`` on a mesh, sharded over the channel axis R as
    the reference's rules lay it out: each rank computes its R / tp
    channels.  ``w_gate``, ``w_x``, ``conv_w``, ``w_r`` and ``w_i`` are
    column-parallel, ``conv_b`` and ``lam`` whole (each rank takes its
    slice), ``w_out`` row-parallel; the r and i gates read the conv output
    whole over R (one all-gather).  The state's h and tail stay sharded
    on R.  The output is a partial sum over ``model``, reduced at the
    residual."""
    ax, b = ctx.model_axis, act_spec(ctx)[0]
    cols = sh.cols(cfg.lru_width or cfg.d_model)
    dp = tuple(ctx.batch_axes)

    def f(x_l, ln, w_gate, w_x, conv_w, conv_b, w_r, w_i, lam, w_out, h0,
          tail):
        xn = rms_norm(x_l, ln)
        gate = F.gelu((xn @ w_gate).float(), approximate="tanh")
        y, new_tail = _causal_conv(xn @ w_x, conv_w, conv_b[cols], tail)
        h, h_last = rg_lru(y, {"w_r": w_r, "w_i": w_i, "lam": lam[cols]},
                           h0, sh.gather(y))
        return ((h * gate).to(cfg.dtype) @ w_out, h_last,
                new_tail.to(cfg.dtype))

    st = state or {"h": None, "tail": None}
    col, whole, rep = (None, ax), (None,), (ax,) + dp
    return _local(
        f, ctx, ((b, None, None), whole, col, col, col, whole, col, col,
                 whole, (ax, None), (b, ax), (b, None, ax)),
        [(b, None, None), (b, ax), (b, None, ax)],
        grad_partial=((ax,), rep, dp, dp, dp, rep, dp, dp, rep, dp, (),
                      ()), out_partial=(ax,))(
        x, p["ln"]["scale"], p["w_gate"], p["w_x"], p["conv_w"], p["conv_b"],
        p["w_r"], p["w_i"], p["lam"], p["w_out"], st["h"], st["tail"])


def attn_mixer_apply(x, p, cfg: ModelConfig, positions, cache=None,
                     slot=None, pages=None, ctx=None):
    """Local attention.  A prompt (cache None) attends on the flash kernel
    with the window and returns its keys and values; a decode token writes
    its K/V into the ring ``cache`` at ``slot`` = (rows, slot index) and
    attends over it through ``pages``."""
    xn = rms_norm(x, p["ln1"]["scale"])
    q, k, v = qkv_proj(xn, p["attn"], cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                       ctx)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if cache is not None and on_mesh(ctx):
        out = mesh_decode_attend(q, cache["k"], cache["v"], cache["pos"], k,
                                 v, pages, ctx)
    elif cache is not None:
        out = decode_update_and_attend(q, cache["k"], cache["v"],
                                       cache["pos"], k, v, slot, pages,
                                       pos=positions[:, 0])
    elif on_mesh(ctx):
        out = mesh_attention(q, k, v, ctx, causal=True,
                             window=cfg.attn_window)
    else:
        out = flash_attention(q, k, v, causal=True, window=cfg.attn_window)
    return out_proj(out, p["attn"], ctx), (k, v)


def rg_layer_apply(x, p, kind, cfg, positions, state=None, slot=None,
                   pages=None, ctx=None):
    """-> (x, the recurrent layer's new state, or the attention layer's
    new keys and values)."""
    sh = model_shard(ctx, cfg.lru_width or cfg.d_model)
    if kind == "rec" and sh is not None:
        out, h, tail = rec_mixer_mesh(x, p["rec"], cfg, state, ctx, sh)
        mix, new = out, {"h": h, "tail": tail}
    elif kind == "rec" and on_mesh(ctx):
        mix, new = whole_over_model(lambda x_, p_, st_: rec_mixer_apply(
            x_, p_, cfg, st_), ctx, x, p["rec"], state)
    elif kind == "rec":
        mix, new = rec_mixer_apply(x, p["rec"], cfg, state)
    else:
        mix, new = attn_mixer_apply(x, p, cfg, positions, state, slot, pages,
                                    ctx)
    # the mixer's and the MLP's partial sums reduced at the residual, as
    # in ``transformer.block_apply``
    x = x + constrain(mix, ctx, act_spec(ctx))
    x = x + mlp_apply(rms_norm(x, p["ln2"]["scale"]), p["mlp"], cfg.act)
    return constrain(x, ctx, act_spec(ctx)), new


# --------------------------------------------------------------- full model
def n_groups(cfg: ModelConfig) -> tuple[int, int]:
    g = cfg.n_layers // len(PATTERN)
    return g, cfg.n_layers - g * len(PATTERN)


def init_rg(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn in a fixed order (embed,
    head, then each layer in execution order)."""
    G, tail = n_groups(cfg)
    d, V, dev = cfg.d_model, cfg.vocab, gen.device
    params = {"embed": _normal(gen, (V, d), 1.0 / math.sqrt(d), cfg.dtype),
              "head": _normal(gen, (d, V), 1.0 / math.sqrt(d), cfg.dtype),
              "final_norm": init_norm(d, "rms", dev)}
    params["groups"] = [{key: init_rg_layer(gen, cfg, kind)
                         for key, kind in zip(GROUP_KEYS, PATTERN)}
                        for _ in range(G)]
    for t in range(tail):
        params[f"tail{t}"] = init_rg_layer(gen, cfg, "rec")
    return params


def rg_states(cfg: ModelConfig, B: int, device="cuda", ctx=None) -> dict:
    """The zeroed decode state: recurrences at 0, the ring's W slots empty
    (pos -1).  On a mesh each rank allocates only its own shard of
    ``cache_spec_tree``'s placements (``filled_tree``)."""
    G, tail = n_groups(cfg)
    R = cfg.lru_width or cfg.d_model
    W = cfg.attn_window
    dev = "meta" if on_mesh(ctx) else device

    def rec(*lead):
        return {"h": torch.zeros((*lead, B, R), dtype=torch.float32,
                                 device=dev),
                "tail": torch.zeros((*lead, B, CONV_W - 1, R),
                                    dtype=cfg.dtype, device=dev)}

    kv = (G, B, W, cfg.n_kv_heads, cfg.hd)
    st = {"groups": {
        "rec1": rec(G), "rec2": rec(G),
        "attn": {"k": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                 "v": torch.zeros(kv, dtype=cfg.dtype, device=dev),
                 "pos": torch.full((G, B, W), -1, dtype=torch.int32,
                                   device=dev)}}}
    for t in range(tail):
        st[f"tail{t}"] = rec()
    if on_mesh(ctx):
        st = filled_tree(st, cache_spec_tree(st, ctx), ctx.mesh, device,
                         fill={"pos": -1})
    return st


def _layers(params, cfg: ModelConfig):
    """(kind, layer, state key, group index or None) in execution order."""
    for g, grp in enumerate(params["groups"]):
        for key, kind in zip(GROUP_KEYS, PATTERN):
            yield kind, grp[key], key, g
    for t in range(n_groups(cfg)[1]):
        yield "rec", params[f"tail{t}"], f"tail{t}", None


def _embed(params, tokens, cfg: ModelConfig, ctx=None):
    x = embed(params["embed"], tokens, ctx) * math.sqrt(cfg.d_model)
    return constrain(x.to(cfg.dtype), ctx, act_spec(ctx))


def _head(params, x):
    x = rms_norm(x, params["final_norm"]["scale"])
    return (x @ params["head"]).float()


def rg_backbone(params, tokens, cfg: ModelConfig, collect: bool,
                mode: str = "none", ctx=None):
    """-> (final hidden states (B,T,D), the decode state or None).  Each
    group runs under ``remat(mode)``; the trailing layers as they are."""
    tokens, positions = prompt_positions(tokens, params["embed"].device)
    B, T = tokens.shape
    x = _embed(params, tokens, cfg, ctx)
    states = rg_states(cfg, B, tokens.device, ctx) if collect else None
    W = cfg.attn_window
    n = min(T, W)
    ring = torch.arange(T - n, T, device=tokens.device) % W

    def keep(kind, st, g, new):
        if kind == "attn" and on_mesh(ctx):
            fill_cache_shard({k: v[g] for k, v in st.items()}, *new,
                             positions, T, n, W, ctx)
        elif kind == "attn":
            # the last min(T, W) keys, position p in slot p % W
            st["k"][g][:, ring] = new[0][:, T - n:].to(cfg.dtype)
            st["v"][g][:, ring] = new[1][:, T - n:].to(cfg.dtype)
            st["pos"][g][:, ring] = positions[:, T - n:].to(torch.int32)
        else:
            for k in ("h", "tail"):
                (st[k] if g is None else st[k][g]).copy_(new[k])

    def group(h, grp):
        news = []
        for key, kind in zip(GROUP_KEYS, PATTERN):
            h, new = rg_layer_apply(h, grp[key], kind, cfg, positions,
                                    ctx=ctx)
            news.append(new)
        return h, news

    group = remat(group, mode)
    for g, grp in enumerate(params["groups"]):
        x, news = group(x, grp)
        if collect:
            for key, kind, new in zip(GROUP_KEYS, PATTERN, news):
                keep(kind, states["groups"][key], g, new)
    for t in range(n_groups(cfg)[1]):
        x, new = rg_layer_apply(x, params[f"tail{t}"], "rec", cfg, positions,
                                ctx=ctx)
        if collect:
            keep("rec", states[f"tail{t}"], None, new)
    return x, states


def rg_forward(params, batch, cfg: ModelConfig, ctx=None):
    """Logits (B, T, V).  Each group runs under ``remat``, as the
    reference's scan body does: its ``_remat`` recomputes the whole group
    for "dots" as for "full"."""
    x, _ = rg_backbone(params, batch["tokens"], cfg, False,
                       "none" if cfg.remat == "none" else "full", ctx)
    return _head(params, x)


def rg_loss(params, batch, cfg: ModelConfig, ctx=None):
    """Mean next-token NLL over every position (the reference's loss
    takes no mask)."""
    return token_nll(rg_forward(params, batch, cfg, ctx), batch["targets"],
                     ctx).mean()


def rg_prefill(params, batch, cfg: ModelConfig, ctx=None):
    """-> (last-token logits (B, V), the decode state with a W-slot ring)."""
    x, states = rg_backbone(params, batch["tokens"], cfg, True, ctx=ctx)
    return _head(params, x[:, -1:])[:, 0], states


def rg_decode_step(params, state, token, pos, cfg: ModelConfig, ctx=None):
    """One serve step: token (B,), absolute positions pos (B,) -> (logits
    (B, V), the state updated in place).  Each row's ring must hold
    min(pos, W) tokens, as a prefill and one step at each later position
    leave it (ValueError otherwise: the kernel reads slots 0..min(pos,
    W - 1))."""
    dev = params["embed"].device
    pos = torch.as_tensor(pos, device=dev).long()
    W = cfg.attn_window
    filled = (state["groups"]["attn"]["pos"][0] >= 0).sum(dim=-1)
    if on_mesh(ctx):
        filled = filled.full_tensor()
    check_decode_positions(pos, filled, W, True)
    token = torch.as_tensor(token, device=dev).long()
    B = token.shape[0]
    positions = pos[:, None]
    x = _embed(params, token[:, None], cfg, ctx)
    # the ring's slot and pages once a step, shared by every attn layer
    n_rep = cfg.n_heads // cfg.n_kv_heads
    if on_mesh(ctx):
        slot, pages = None, mesh_decode(pos, W, n_rep, ctx, ring=True)
    else:
        slot = (torch.arange(B, device=dev), pos % W)
        pages = decode_pages(torch.clamp(pos + 1, max=W), W, n_rep)
    for kind, layer, key, g in _layers(params, cfg):
        st = state[key] if g is None else {
            k: v[g] for k, v in state["groups"][key].items()}
        x, new = rg_layer_apply(x, layer, kind, cfg, positions, state=st,
                                slot=slot, pages=pages, ctx=ctx)
        if kind == "rec":
            for k in ("h", "tail"):
                st[k].copy_(new[k])
    return _head(params, x)[:, 0], state
