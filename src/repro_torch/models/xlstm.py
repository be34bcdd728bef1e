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
of einsums inside two operators, ``repro_torch::mlstm_scores`` and
``mlstm_hidden``, ``mlstm_op.py``) where T is a multiple of the chunk,
else the step recurrence; the sLSTM is a loop over time inside one
operator (``repro_torch::slstm_scan``, ``slstm_op.py``).  Each operator
has a backward of its own.  All are plain PyTorch: the reference runs
them outside any Pallas kernel.  The decode step writes the new state into
the state it was given, IN PLACE, and returns it.

On a mesh (``ctx``) the parameters are DTensors and each mixer runs
split over ``model`` in a ``local_map`` region (``mlstm_mesh``,
``slstm_mesh``: the reference's column- and row-parallel products, the
mLSTM's state split on its value and key channels as
``parallel.sharding.cache_spec_tree`` places it, the sLSTM's recurrence
whole), or in ``layers.whole_over_model`` where the model axis does not
divide the head width; the decode state is a tree of DTensors of
``cache_spec_tree``'s placements.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import cache_spec_tree, filled_tree
from .common import ModelConfig, remat
from .layers import (ModelShard, _local, _normal, act_spec, constrain,
                     embed, init_norm, model_shard, on_mesh,
                     prompt_positions, rms_norm, token_nll,
                     whole_over_model)
from .mlstm_op import mlstm_chunkwise_op
from .slstm_op import slstm_scan_op

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


# A train step keeps a whole group's saved tensors from its recompute to
# its backward (``_backbone``'s remat, the reference's).  Two of the
# blocks' steps would keep f32 copies of their (B, T, D) input there:
# the norm (its f32 input and product) and the gates' f32 products.  These
# keep the input in its own dtype and make the rest again in the backward.
class _NormKeepingInput(torch.autograd.Function):
    """``rms_norm(x, scale)``; the backward runs the norm again under
    autograd, from x."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return rms_norm(x, scale)

    @staticmethod
    def backward(ctx, g):
        x, scale = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = rms_norm(x, scale)
        return torch.autograd.grad(y, (x, scale), g)


class _F32Product(torch.autograd.Function):
    """``x.float() @ w`` for x (..., D) and an f32 w (D, n); the backward
    casts x again for w's gradient."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x.float() @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        return ((g @ w.t()).to(x.dtype),
                x.float().reshape(-1, x.shape[-1]).t() @ g2)


_norm = _NormKeepingInput.apply
_f32_product = _F32Product.apply


def _whole(*ts):
    """The partial sums of a rank that holds every channel: themselves."""
    return ts


def _mlstm_step(state, q, k, v, ipre, fpre, ks=slice(None), psum=_whole):
    """One recurrence step. q/k/v: (B,H,dh) f32; ipre/fpre: (B,H).  On a
    mesh v and C's rows are this rank's value channels, n its key
    channels ``ks``, and ``psum`` sums the normaliser's dot over the
    ranks."""
    C, n, m = state["C"], state["n"], state["m"]
    logf = F.logsigmoid(fpre)
    m_new = torch.maximum(logf + m, ipre)
    i_g = torch.exp(ipre - m_new)
    f_g = torch.exp(logf + m - m_new)
    C_new = f_g[..., None, None] * C + \
        i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k[..., ks]
    dot, = psum(torch.einsum("bhd,bhd->bh", n_new, q[..., ks]))
    denom = torch.maximum(dot.abs(), torch.exp(-m_new))
    h = torch.einsum("bhde,bhe->bhd", C_new, q) / denom[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, h


def mlstm_chunkwise(q, k, v, ipre, fpre, s0, *, chunk: int,
                    ks=slice(None), psum=_whole):
    """Chunkwise-parallel mLSTM, the reference's form: one state carried
    per chunk, the intra-chunk work as einsums, the same stabiliser M and
    the same chunk-end state, as the two ``repro_torch`` ops of
    ``mlstm_op.py`` (each chunk cast to f32 as it is read, which holds
    each bf16 value exactly; the reference's einsums take bf16 operands
    with f32 accumulation).

    q/k/v: (B,T,H,dh);  ipre/fpre: (B,T,H) f32;  s0: {C,n,m}.
    Returns (h (B,T,H,dh) f32, final state).  On a mesh v, C's rows and
    h are this rank's value channels, n its key channels ``ks``; the
    scores and the normaliser's dots are summed over the ranks from
    their key channels (``psum``, one all-reduce for all the chunks)."""
    T = q.shape[1]
    L = min(chunk, T)
    assert T % L == 0, (T, L)
    h, C, n, m = mlstm_chunkwise_op(q, k, v, ipre, fpre, s0["C"], s0["n"],
                                    s0["m"], L, ks, psum)
    return h, {"C": C, "n": n, "m": m}


def mlstm_core(q, k, v, ipre, fpre, s, chunk: int, ks=slice(None),
               psum=_whole):
    """The recurrence over q/k/v (B,T,H,dh) from the state ``s``: T > 1
    takes the chunkwise form where T is a multiple of min(chunk, T), else
    the step recurrence.  -> (h (B,T,H,dh) f32, the final state)."""
    T = q.shape[1]
    if T > 1 and T % min(chunk, T) == 0:
        return mlstm_chunkwise(q, k, v, ipre, fpre, s, chunk=min(chunk, T),
                               ks=ks, psum=psum)
    q32, k32, v32 = q.float(), k.float(), v.float()
    hs = []
    for t in range(T):
        s, ht = _mlstm_step(s, q32[:, t], k32[:, t], v32[:, t], ipre[:, t],
                            fpre[:, t], ks, psum)
        hs.append(ht)
    return torch.stack(hs, dim=1), s


def mlstm_apply(x, p, cfg: ModelConfig, state=None, chunk: int = 128):
    """x: (B,T,D) -> ((B,T,D), final state).  With ``state`` the recurrence
    continues from it (decode, T == 1).  T > 1 takes the chunkwise form
    where T is a multiple of min(chunk, T), else the step recurrence."""
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    xn = _norm(x, p["ln"]["scale"])
    # the scale in the model dtype, as the reference multiplies by it
    scale = torch.tensor(1.0 / math.sqrt(dh), dtype=cfg.dtype,
                         device=x.device)
    q = (xn @ p["wq"]).reshape(B, T, H, dh) * scale
    k = (xn @ p["wk"]).reshape(B, T, H, dh) * scale
    v = (xn @ p["wv"]).reshape(B, T, H, dh)
    og = torch.sigmoid((xn @ p["wog"]).float()).to(cfg.dtype)
    gates = _f32_product(xn, p["wif"]) + p["bif"]
    ipre, fpre = gates[..., :H], gates[..., H:]
    s = state if state is not None else mlstm_state(cfg, B, x.device)
    h, s = mlstm_core(q, k, v, ipre, fpre, s, chunk)
    out = (h.reshape(B, T, D).to(cfg.dtype) * og) @ p["wout"]
    return out, s


def _dims(x, cfg: ModelConfig, sh: ModelShard):
    B, T, D = x.shape
    H = cfg.n_heads
    return B, T, D, H, D // H, sh.cols(D // H)


def mlstm_mesh(x, p, cfg: ModelConfig, state, ctx, sh: ModelShard,
               chunk: int = 128):
    """``mlstm_apply`` on a mesh, split over ``model`` as the reference's
    rules lay it out: ``wq``, ``wk``, ``wv``, ``wog`` (and ``wif`` where
    2H divides the axis) column-parallel, ``wout`` row-parallel.  Each
    rank holds, of every head, its dh / tp value channels (C's rows, as
    ``cache_spec_tree`` shards the state) and its dh / tp key channels
    (n's): q and k are gathered whole (C's columns and its query read
    every key channel), v is sliced to this rank's value channels, and
    the scores and the normaliser's dots are summed over the ranks from
    each one's key channels.  No product runs whole.  h is gathered back
    to the flat axis, where ``og`` and ``wout`` take this rank's rows;
    the output is a partial sum over ``model``.  The stabiliser m is held
    whole on every rank."""
    ax, b = ctx.model_axis, act_spec(ctx)[0]
    H = cfg.n_heads
    wif_col = 2 * H % sh.size == 0 and 2 * H >= sh.size
    dp = tuple(ctx.batch_axes)

    def f(x_l, ln, wq, wk, wv, wog, wif, bif, wout, C, n, m):
        B, T, D, H, dh, ks = _dims(x_l, cfg, sh)
        xn = _norm(x_l, ln)
        scale = torch.tensor(1.0 / math.sqrt(dh), dtype=cfg.dtype,
                             device=x_l.device)
        q = sh.gather(xn @ wq).reshape(B, T, H, dh) * scale
        k = sh.gather(xn @ wk).reshape(B, T, H, dh) * scale
        v = sh.gather(xn @ wv).reshape(B, T, H, dh)[..., ks]
        og = torch.sigmoid((xn @ wog).float()).to(cfg.dtype)
        gates = _f32_product(xn, wif)
        gates = (sh.gather(gates) if wif_col else gates) + bif
        if C is None:
            z = dict(dtype=torch.float32, device=x_l.device)
            C = torch.zeros((B, H, dh // sh.size, dh), **z)
            n = torch.zeros((B, H, dh // sh.size), **z)
            m = torch.full((B, H), NEG, **z)
        h, s = mlstm_core(q, k, v, gates[..., :H], gates[..., H:],
                          {"C": C, "n": n, "m": m}, chunk, ks, sh.sum)
        # this rank's columns alone, not a view that keeps h whole
        h = sh.gather(h.to(cfg.dtype)).reshape(B, T, D)[..., sh.cols(D)] \
            .contiguous()
        return (h * og) @ wout, s["C"], s["n"], s["m"]

    st = state or {"C": None, "n": None, "m": None}
    col, whole, rep = (None, ax), (None,), (ax,) + dp
    return _local(
        f, ctx, ((b, None, None), whole, col, col, col, col,
                 col if wif_col else (None, None), whole, (ax, None),
                 (b, None, ax, None), (b, None, ax), (b, None)),
        [(b, None, None), (b, None, ax, None), (b, None, ax), (b, None)],
        grad_partial=((ax,), rep, dp, dp, dp, dp, dp if wif_col else rep,
                      rep, dp, (), (), ()), out_partial=(ax,))(
        x, p["ln"]["scale"], p["wq"], p["wk"], p["wv"], p["wog"], p["wif"],
        p["bif"], p["wout"], st["C"], st["n"], st["m"])


def slstm_apply(x, p, cfg: ModelConfig, state=None):
    """x: (B,T,D) -> ((B,T,D), final state), one step per token.  The
    three recurrent projections of h run as one batched matmul a step."""
    B, T, D = x.shape
    H = cfg.n_heads
    dh = D // H
    xn = _norm(x, p["ln"]["scale"])
    z_in = (xn @ p["wz"]).reshape(B, T, H, dh).float()
    o_in = (xn @ p["wo"]).reshape(B, T, H, dh).float()
    i_in = _f32_product(xn, p["wi"])
    f_in = _f32_product(xn, p["wf"]) + p["bf"]
    s = state if state is not None else slstm_state(cfg, B, x.device)
    hs, s = slstm_scan(z_in, o_in, i_in, f_in, p, s)
    return hs.reshape(B, T, D).to(cfg.dtype) @ p["wout"], s


def slstm_scan(z_in, o_in, i_in, f_in, p, s):
    """The sLSTM's recurrence from the state ``s``, one step a token, as
    one ``repro_torch::slstm_scan`` (``slstm_op.py``): z_in/o_in
    (B,T,H,dh) f32, i_in/f_in (B,T,H) -> (h (B,T,H,dh), the final
    state)."""
    # (H, dh, dh + 2): rz, ri, rf side by side
    rec = torch.cat([p["rz"].float(), p["ri"], p["rf"]], dim=-1)
    hs, c, n, h, m = slstm_scan_op(z_in, o_in, i_in, f_in, rec, s["c"],
                                   s["n"], s["h"], s["m"])
    return hs, {"c": c, "n": n, "h": h, "m": m}


def slstm_mesh(x, p, cfg: ModelConfig, state, ctx, sh: ModelShard):
    """``slstm_apply`` on a mesh: ``wz`` (and ``wi``/``wf`` where H
    divides the axis) column-parallel and gathered whole, ``wo``
    row-parallel (the reference's rules take it for an out-projection)
    and summed over the ranks, ``wout`` row-parallel on this rank's rows
    of h.  The recurrence
    through ``rz``, which the reference's rules keep whole
    (``parallel/sharding.py``'s ``_REPL_KEYS``), runs whole on every rank
    of ``model``, its state gathered whole; the state goes back to
    ``cache_spec_tree``'s shards where it is kept.  The output is a
    partial sum over ``model``."""
    ax, b = ctx.model_axis, act_spec(ctx)[0]
    H = cfg.n_heads
    gate_col = H % sh.size == 0 and H >= sh.size
    dp = tuple(ctx.batch_axes)

    def f(x_l, ln, wz, wo, wi, wf, rz, ri, rf, bf, wout, c, n, h, m):
        B, T, D, H, dh, _ = _dims(x_l, cfg, sh)
        xn = _norm(x_l, ln)
        z_in = sh.gather(xn @ wz).reshape(B, T, H, dh).float()
        o_in, = sh.sum(xn[..., sh.cols(D)] @ wo)
        o_in = o_in.reshape(B, T, H, dh).float()
        i_in, f_in = _f32_product(xn, wi), _f32_product(xn, wf)
        if gate_col:
            i_in, f_in = sh.gather(i_in), sh.gather(f_in)
        s = ({"c": c, "n": n, "h": h, "m": m} if c is not None
             else slstm_state(cfg, B, x_l.device))
        hs, s = slstm_scan(z_in, o_in, i_in, f_in + bf,
                           {"rz": rz, "ri": ri, "rf": rf}, s)
        hs = hs.reshape(B, T, D)[..., sh.cols(D)].to(cfg.dtype)
        return hs @ wout, s["c"], s["n"], s["h"], s["m"]

    st = state or {"c": None, "n": None, "h": None, "m": None}
    col, rep = (None, ax), (ax,) + dp
    gate = col if gate_col else (None, None)
    whole3, state4 = (None,) * 3, (b, None, None)
    return _local(
        f, ctx, ((b, None, None), (None,), col, (ax, None), gate, gate,
                 whole3, whole3, whole3, (None,), (ax, None), state4,
                 state4, state4, (b, None)),
        [(b, None, None), state4, state4, state4, (b, None)],
        grad_partial=((ax,), rep, dp, dp, dp if gate_col else rep,
                      dp if gate_col else rep, rep, rep, rep, rep, dp, (),
                      (), (), ()), out_partial=(ax,))(
        x, p["ln"]["scale"], p["wz"], p["wo"], p["wi"], p["wf"], p["rz"],
        p["ri"], p["rf"], p["bf"], p["wout"], st["c"], st["n"], st["h"],
        st["m"])


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
    """The zeroed decode state (each ``m`` at ``NEG``).  On a mesh each
    rank allocates only its own shard of ``cache_spec_tree``'s placements
    (``filled_tree``)."""
    G = cfg.n_layers // GROUP
    dev = "meta" if on_mesh(ctx) else device
    st = {"m": mlstm_state(cfg, B, dev, (G, GROUP - 1)),
          "s": slstm_state(cfg, B, dev, (G,))}
    if on_mesh(ctx):
        st = filled_tree(st, cache_spec_tree(st, ctx), ctx.mesh, device,
                         fill={"m": NEG})
    return st


def _on_cache_spec(st: dict, ctx) -> dict:
    """A state of whole tensors (or of DTensors) with the placements of
    ``cache_spec_tree`` on a mesh; ``st`` itself off it."""
    if not on_mesh(ctx):
        return st
    specs = cache_spec_tree(st, ctx)
    return {part: {k: constrain(v, ctx, specs[part][k])
                   for k, v in st[part].items()} for part in st}


def _mixer(fn, mesh_fn, keys: tuple, cfg: ModelConfig, ctx):
    """``fn(x, p, cfg, state=...)``; on a mesh whose model axis divides
    the head width ``mesh_fn``, split over it (its new state's tensors
    those of ``keys``, in order), else ``fn`` in ``whole_over_model``.
    -> (out, new state)."""
    if not on_mesh(ctx):
        return lambda x, p, state=None: fn(x, p, cfg, state=state)
    sh = model_shard(ctx, cfg.d_model // cfg.n_heads)
    if sh is None:
        return lambda x, p, state=None: whole_over_model(
            lambda x_, p_, st_: fn(x_, p_, cfg, state=st_), ctx, x, p, state)

    def run(x, p, state=None):
        out, *new = mesh_fn(x, p, cfg, state, ctx, sh)
        # the partial sums reduced before the residual
        return constrain(out, ctx, act_spec(ctx)), dict(zip(keys, new))
    return run


def _backbone(params, x, cfg: ModelConfig, state=None, collect=False,
              mode: str = "none", ctx=None):
    """The blocks over x (B,T,D), each group under ``remat(mode)``.
    ``state``: continue from it and write the new state into it;
    ``collect``: return the final states, stacked in the reference's
    layout."""

    mlstm = _mixer(mlstm_apply, mlstm_mesh, ("C", "n", "m"), cfg, ctx)
    slstm = _mixer(slstm_apply, slstm_mesh, ("c", "n", "h", "m"), cfg, ctx)

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
    x = embed(params["embed"],
              prompt_positions(tokens, params["embed"].device)[0], ctx)
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
    takes no mask)."""
    return token_nll(xlstm_forward(params, batch, cfg, ctx),
                     batch["targets"], ctx).mean()


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
