"""Transformer families, as ``repro.models.transformer``: the
decoder-only LM (dense and MoE), the encoder-decoder (whisper) and the
VLM with interleaved cross-attention layers (llama-vision); random init
from a ``torch.Generator``; and the converters from a JAX parameter pytree
(and back, ``params_to_jax``) and a JAX decode state or cache, for every
family (the recurrent ones live in ``models/xlstm.py`` and
``models/rglru.py``).

Parameters are a plain dict: ``embed`` (V, D), ``head`` (D, V) unless tied,
``final_norm``, and the layers as lists with one dict per layer (the
reference stacks them on a leading axis for its scan): ``blocks`` (dense,
moe: ``ln1``, ``attn``, ``ln2``, and ``mlp`` or ``moe``); ``enc_blocks``,
``enc_norm`` and ``dec_blocks`` (encdec; a decoder block also carries
``lnx``, ``xattn`` and the scalar ``xgate``); ``groups`` (vlm), a list of
``{"self": [cross_every - 1 blocks], "cross": block}``.

Attention runs on the port's kernels: every self-attention over a prompt
and every cross-attention over frames or patches on
``kernels.ops.flash_attention`` (causal for decoder self-attention,
non-causal for the encoder and cross-attention), every decode attention
on ``kernels.ops.paged_attention`` over the contiguous cache viewed as
pages (``layers.decode_attention``).  CPU tensors take each kernel's
plain version.  The layer loop runs on the host in Python.  The decode
step writes the new token's K/V into the cache IN PLACE and returns the
cache it was given (the reference returns a new one).  Modality
frontends are stubs, as in the reference: whisper takes frame embeddings
(``frames``), the VLM patch embeddings (``image_embeds``).

Every entry point takes ``ctx`` (a ``MeshCtx``; None is one device).  On
a mesh the parameters are DTensors of ``parallel.sharding``'s placements,
DTensor's sharding propagation partitions the dense products as GSPMD
does in the reference, ``constrain`` stands on the reference's lines,
and the attention and MoE regions run as ``local_map`` regions
(``layers.mesh_attention``, ``layers.mesh_decode_attend``,
``layers.moe_apply``); the cache is a tree of DTensors of
``parallel.sharding.cache_spec_tree``'s placements.  The caller runs the
model inside ``layers.mesh_scope(ctx)``, which the API's entry points do.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ops import flash_attention
from .common import ModelConfig, remat
from repro_torch.parallel.sharding import cache_spec_tree, distribute_tree
from .layers import (_local, act_spec, apply_norm, attn_init,
                     check_decode_positions, constrain, decode_pages,
                     fill_cache_shard,
                     decode_update_and_attend, decode_attention, init_norm,
                     mesh_attention, mesh_decode, mesh_decode_attend,
                     mlp_apply, mlp_init, moe_apply, moe_init, on_mesh,
                     out_proj, prompt_positions, qkv_proj, rope,
                     sinusoidal_pos, token_nll, heads)


# =========================================================== block def/init
def init_block(gen: torch.Generator, cfg: ModelConfig, *,
               cross: bool = False) -> dict:
    d, hd, dev = cfg.d_model, cfg.hd, gen.device
    p = {"ln1": init_norm(d, cfg.norm, dev),
         "attn": attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, hd,
                           cfg.qkv_bias, cfg.dtype)}
    if cross:
        p["lnx"] = init_norm(d, cfg.norm, dev)
        p["xattn"] = attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, hd,
                               False, cfg.dtype)
        p["xgate"] = torch.zeros((), dtype=torch.float32, device=dev)
    p["ln2"] = init_norm(d, cfg.norm, dev)
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, d, cfg.moe, cfg.dtype)
    else:
        p["mlp"] = mlp_init(gen, d, cfg.d_ff, cfg.act, cfg.dtype)
    return p


def self_attention(x, p, cfg: ModelConfig, *, positions, causal=True,
                   window=0, cache=None, slot=None, pos=None, pages=None,
                   ctx=None):
    """Returns (attn_out, k, v), k and v being this call's new keys and
    values.  With ``cache`` (one layer's ``{"k", "v", "pos"}``), x is the
    single new token (B, 1, D) at positions ``pos``: its K/V go into the
    cache at ``slot`` and it attends over the cache through ``pages`` (on
    a mesh, a ``layers.MeshDecode``)."""
    q, k, v = qkv_proj(x, p, cfg.n_heads, cfg.n_kv_heads, cfg.hd, ctx)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is not None and on_mesh(ctx):
        out = mesh_decode_attend(q, cache["k"], cache["v"], cache["pos"],
                                 k, v, pages, ctx)
    elif cache is not None:
        out = decode_update_and_attend(q, cache["k"], cache["v"],
                                       cache["pos"], k, v, slot, pages, pos)
    elif on_mesh(ctx):
        out = mesh_attention(q, k, v, ctx, causal=causal, window=window)
    else:
        out = flash_attention(q, k, v, causal=causal, window=window)
    return out_proj(out, p), k, v


def cross_attention(x, p, cfg: ModelConfig, *, xk, xv, pages=None,
                    ctx=None):
    """Full attention of x over xk/xv: the flash kernel (non-causal, any
    T against S), or the paged kernel through ``pages`` in decode (on a
    mesh, the pages of this rank's batch rows)."""
    B, T, _ = x.shape
    q = heads(x @ p["wq"], cfg.n_heads, cfg.hd, ctx)
    if not on_mesh(ctx):
        out = (decode_attention(q, xk, xv, pages) if pages is not None
               else flash_attention(q, xk, xv, causal=False))
    elif pages is None:
        out = mesh_attention(q, xk, xv, ctx, causal=False)
    else:
        whole = act_spec(ctx, 4)
        out = _local(lambda q_l, k_l, v_l: decode_attention(
            q_l.contiguous(), k_l, v_l, pages), ctx, (whole,) * 3,
            whole)(q, xk, xv)
    return out_proj(out, p)


def cross_kv(enc_out, p, cfg: ModelConfig, ctx=None):
    k = heads(enc_out @ p["wk"], cfg.n_kv_heads, cfg.hd, ctx)
    v = heads(enc_out @ p["wv"], cfg.n_kv_heads, cfg.hd, ctx)
    return k, v


def block_apply(x, p, cfg: ModelConfig, *, positions, causal=True, window=0,
                cache=None, slot=None, pos=None, pages=None, xk=None,
                xv=None, xpages=None, ctx=None):
    """Returns (x, (k, v)) with the self-attention's new keys and values."""
    a, k, v = self_attention(
        apply_norm(x, p["ln1"], cfg.norm), p["attn"], cfg,
        positions=positions, causal=causal, window=window, cache=cache,
        slot=slot, pos=pos, pages=pages, ctx=ctx)
    x = x + a
    if xk is not None:
        g = torch.tanh(p["xgate"]).to(x.dtype) if "xgate" in p else 1.0
        c = cross_attention(apply_norm(x, p["lnx"], cfg.norm), p["xattn"],
                            cfg, xk=xk, xv=xv, pages=xpages, ctx=ctx)
        x = x + g * c
    h = apply_norm(x, p["ln2"], cfg.norm)
    if cfg.moe is not None:
        x = x + moe_apply(h, p["moe"], cfg.moe, ctx)
    else:
        x = x + mlp_apply(h, p["mlp"], cfg.act)
    return constrain(x, ctx, act_spec(ctx)), (k, v)


# ============================================================= LM (decoder)
def init_lm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random parameters on ``gen.device``, drawn in a fixed order (embed,
    head, then each layer in execution order, the encoder first) so one
    seed gives one model."""
    d, V = cfg.d_model, cfg.vocab
    dev = gen.device
    params = {"embed": (torch.randn((V, d), generator=gen, device=dev)
                        / math.sqrt(d)).to(cfg.dtype),
              "final_norm": init_norm(d, cfg.norm, dev)}
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((d, V), generator=gen, device=dev)
                          / math.sqrt(d)).to(cfg.dtype)
    if cfg.family == "vlm":
        inner = cfg.cross_every - 1
        params["groups"] = [
            {"self": [init_block(gen, cfg) for _ in range(inner)],
             "cross": init_block(gen, cfg, cross=True)}
            for _ in range(cfg.n_layers // cfg.cross_every)]
    elif cfg.family == "encdec":
        enc_cfg = cfg.with_(act="gelu")
        params["enc_blocks"] = [init_block(gen, enc_cfg)
                                for _ in range(cfg.enc_layers)]
        params["enc_norm"] = init_norm(d, cfg.norm, dev)
        params["dec_blocks"] = [init_block(gen, cfg, cross=True)
                                for _ in range(cfg.n_layers)]
    else:
        params["blocks"] = [init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return params


def _device(params) -> torch.device:
    """The parameters' device (a DTensor's is its local tensor's)."""
    return params["embed"].device


def _embed_in(params, tokens, positions, cfg: ModelConfig):
    x = params["embed"][tokens]
    if cfg.pos == "sinusoidal":
        x = x + sinusoidal_pos(positions, cfg.d_model, cfg.dtype)
    return x


def _unembed(params, x, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = x @ w
    return logits.float() if cfg.logits_f32 else logits


def _encoder_apply(params, frames, cfg: ModelConfig, mode: str = "none",
                   ctx=None):
    """Whisper encoder over stub conv-frontend frame embeddings (B,S,D),
    each block under ``remat(mode)``."""
    B, S, _ = frames.shape
    pos = torch.arange(S, device=frames.device)[None].expand(B, S)
    x = frames.to(cfg.dtype) + sinusoidal_pos(pos, cfg.d_model, cfg.dtype)
    x = constrain(x, ctx, act_spec(ctx))
    enc_cfg = cfg.with_(act="gelu")
    layer = remat(lambda h, blk: block_apply(h, blk, enc_cfg, positions=pos,
                                             causal=False, ctx=ctx)[0], mode)
    for blk in params["enc_blocks"]:
        x = layer(x, blk)
    return apply_norm(x, params["enc_norm"], cfg.norm)


def _cross_source(params, batch, cfg: ModelConfig, mode: str = "none",
                  ctx=None):
    """What the cross-attention layers attend over: the encoder's output
    (encdec, its blocks under ``remat(mode)``) or the patch embeddings
    (vlm); None for the other families."""
    dev = _device(params)
    if cfg.family == "encdec":
        return _encoder_apply(params, torch.as_tensor(batch["frames"],
                                                      device=dev), cfg, mode,
                              ctx)
    if cfg.family == "vlm":
        return constrain(torch.as_tensor(batch["image_embeds"],
                                         device=dev).to(cfg.dtype),
                         ctx, act_spec(ctx))
    return None


def _blocks(params, cfg: ModelConfig):
    """(block, whether it has cross-attention), in execution order."""
    if cfg.family == "vlm":
        for g in params["groups"]:
            for blk in g["self"]:
                yield blk, False
            yield g["cross"], True
    elif cfg.family == "encdec":
        for blk in params["dec_blocks"]:
            yield blk, True
    else:
        for blk in params["blocks"]:
            yield blk, False


def _window(cfg: ModelConfig) -> int:
    """The self-attention window: the reference passes ``attn_window`` to
    the decoder-only families' layers only."""
    return 0 if cfg.family in ("encdec", "vlm") else cfg.attn_window


def _scan_steps(params, cfg: ModelConfig):
    """The decoder's blocks as the steps of the reference's layer scan,
    each a list of (block, whether it has cross-attention): a vlm group
    (its self-attention blocks, then its cross block), else one block."""
    if cfg.family == "vlm":
        for g in params["groups"]:
            yield [(blk, False) for blk in g["self"]] + [(g["cross"], True)]
    else:
        for unit in _blocks(params, cfg):
            yield [unit]


def lm_forward(params, batch, cfg: ModelConfig, ctx=None):
    """Full-sequence forward -> logits (B, T, V). batch carries 'tokens' and
    family extras ('frames' for encdec, 'image_embeds' for vlm).  Each
    step of the reference's layer scan (a block; a vlm group) runs under
    ``remat(cfg.remat)``, as the reference's does."""
    tokens, positions = prompt_positions(batch["tokens"], _device(params))
    x = constrain(_embed_in(params, tokens, positions, cfg), ctx,
                  act_spec(ctx))
    src = _cross_source(params, batch, cfg, cfg.remat, ctx)

    def scan_step(h, blocks):
        for blk, has_cross in blocks:
            xk, xv = (cross_kv(src, blk["xattn"], cfg, ctx) if has_cross
                      else (None, None))
            h, _ = block_apply(h, blk, cfg, positions=positions,
                               window=_window(cfg), xk=xk, xv=xv, ctx=ctx)
        return h

    scan_step = remat(scan_step, cfg.remat)
    for blocks in _scan_steps(params, cfg):
        x = scan_step(x, blocks)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return _unembed(params, x, cfg)


# ------------------------------------------------------------- loss
def lm_loss(params, batch, cfg: ModelConfig, ctx=None):
    """Mean next-token NLL (the forward value)."""
    # DTensor has no rule for the gather of the gold logit from a
    # vocab-sharded axis: the logits go whole over ``model`` first
    logits = constrain(lm_forward(params, batch, cfg, ctx), ctx,
                       act_spec(ctx))
    nll = token_nll(logits, batch["targets"])
    mask = batch.get("loss_mask")
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=logits.device).to(nll.dtype)
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


# ------------------------------------------------------- prefill / decode
def make_cache(cfg: ModelConfig, B: int, S_max: int, device="cuda",
               cross_len: int | None = None, ctx=None) -> dict:
    """The reference's layout: stacked (L, B, S, Hkv, hd) ``k``/``v`` and
    (L, B, S) ``pos`` (-1 = empty); encdec adds ``cross_k``/``cross_v`` of
    ``cross_len`` (default ``enc_seq``) frames under ``self``; vlm keeps
    ``self`` as (G, cross_every - 1, ...), ``cross_self`` as (G, ...) and
    ``cross_k``/``cross_v`` of ``cross_len`` (default ``n_img_tokens``)
    patches.  A windowed cache is a ring of min(S_max, attn_window)
    slots.  On a mesh every leaf is a DTensor of
    ``parallel.sharding.cache_spec_tree``'s placements."""
    dtype, hd, Hkv = cfg.dtype, cfg.hd, cfg.n_kv_heads
    S = min(S_max, cfg.attn_window) if cfg.attn_window else S_max

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(*lead):
        return {"k": zeros(*lead, B, S, Hkv, hd),
                "v": zeros(*lead, B, S, Hkv, hd),
                "pos": torch.full((*lead, B, S), -1, dtype=torch.int32,
                                  device=device)}

    if cfg.family == "encdec":
        n = cross_len or cfg.enc_seq
        cache = {"self": kv(cfg.n_layers),
                 "cross_k": zeros(cfg.n_layers, B, n, Hkv, hd),
                 "cross_v": zeros(cfg.n_layers, B, n, Hkv, hd)}
    elif cfg.family == "vlm":
        G = cfg.n_layers // cfg.cross_every
        n = cross_len or cfg.n_img_tokens
        cache = {"self": kv(G, cfg.cross_every - 1),
                 "cross_self": kv(G),
                 "cross_k": zeros(G, B, n, Hkv, hd),
                 "cross_v": zeros(G, B, n, Hkv, hd)}
    else:
        cache = kv(cfg.n_layers)
    if on_mesh(ctx):
        cache = distribute_tree(cache, cache_spec_tree(cache, ctx), ctx.mesh)
    return cache


def _self_caches(cache, cfg: ModelConfig):
    """One layer's ``{"k", "v", "pos"}`` views of the cache per decoder
    layer, in execution order (``_blocks``'s)."""
    names = ("k", "v", "pos")
    if cfg.family == "vlm":
        s, cs = cache["self"], cache["cross_self"]
        for g in range(s["k"].shape[0]):
            for i in range(s["k"].shape[1]):
                yield {n: s[n][g, i] for n in names}
            yield {n: cs[n][g] for n in names}
        return
    c = cache["self"] if cfg.family == "encdec" else cache
    for li in range(c["k"].shape[0]):
        yield {n: c[n][li] for n in names}


def _cross_caches(cache):
    for li in range(cache["cross_k"].shape[0]):
        yield cache["cross_k"][li], cache["cross_v"][li]


def _self_len(cache, cfg: ModelConfig) -> int:
    return next(_self_caches(cache, cfg))["k"].shape[1]


def lm_prefill(params, batch, cfg: ModelConfig, s_max: int | None = None,
               ctx=None):
    """Full-context prefill: returns (last-token logits (B, V), populated
    cache).  ``s_max`` pads the cache with empty (pos = -1) slots up to
    ``s_max`` so decode steps can append new tokens.  A windowed cache
    has min(max(T, s_max), W) slots and holds the prompt's last
    min(T, W) tokens in the ring layout, position p in slot p % S (the
    reference's, which pads to W when given ``s_max``)."""
    tokens, positions = prompt_positions(batch["tokens"], _device(params))
    B, T = tokens.shape
    x = constrain(_embed_in(params, tokens, positions, cfg), ctx,
                  act_spec(ctx))
    src = _cross_source(params, batch, cfg, ctx=ctx)
    cache = make_cache(cfg, B, max(T, s_max or 0), device=tokens.device,
                       cross_len=None if src is None else src.shape[1],
                       ctx=ctx)
    S = _self_len(cache, cfg)
    n = min(T, S)                      # T > S only in a full ring (S = W)
    ring = torch.arange(T - n, T, device=tokens.device) % S
    crosses = _cross_caches(cache) if src is not None else None
    for (blk, has_cross), kv in zip(_blocks(params, cfg),
                                    _self_caches(cache, cfg)):
        xk = xv = None
        if has_cross:
            xk, xv = next(crosses)
            for dst, new in zip((xk, xv), cross_kv(src, blk["xattn"], cfg,
                                                   ctx)):
                dst.copy_(constrain(new, ctx, act_spec(ctx, 4)))
        x, (k, v) = block_apply(x, blk, cfg, positions=positions,
                                window=_window(cfg), xk=xk, xv=xv, ctx=ctx)
        if on_mesh(ctx):
            fill_cache_shard(kv, k, v, positions, T, n, S, ctx)
            continue
        kv["k"][:, ring] = k[:, T - n:]
        kv["v"][:, ring] = v[:, T - n:]
        kv["pos"][:, ring] = positions[:, T - n:].to(kv["pos"].dtype)
    x = apply_norm(x[:, -1:], params["final_norm"], cfg.norm)
    return _unembed(params, x, cfg)[:, 0], cache


def lm_decode_step(params, cache, token, pos, cfg: ModelConfig, ctx=None):
    """One serve step: new token (B,), absolute positions pos (B,) ->
    (logits (B, V), the cache updated in place).  The valid slots of each
    row are 0..pos-1 before the step (a prefill, then one step at each
    position), as the reference's serving path leaves them; the paged
    kernel reads slots 0..pos.  A windowed cache of W slots is a ring:
    position p goes in slot p % W, the valid slots are 0..min(pos, W - 1)
    and the kernel reads min(pos + 1, W) of them.  Raises on a position
    outside the cache (IndexError: the reference writes nothing there and
    returns logits without the token, ROADMAP Queue 3 item 2; a windowed
    cache of fewer than W slots is no ring, since wrapping would drop keys
    still inside the window) and on one that is not its row's count of
    valid slots, min(pos, W) in a ring (ValueError: past it, the kernel
    would read never-written slots that the reference masks out).  On a
    mesh ``pos`` and ``token`` are whole on every rank, and the step's
    pages are those of this rank's batch rows and shard of S
    (``layers.mesh_decode``)."""
    dev = _device(params)
    pos = torch.as_tensor(pos, device=dev).long()
    S = _self_len(cache, cfg)
    ring = _window(cfg) > 0 and S == _window(cfg)
    filled = (next(_self_caches(cache, cfg))["pos"] >= 0).sum(dim=-1)
    if on_mesh(ctx):
        filled = filled.full_tensor()
    check_decode_positions(pos, filled, S, ring)
    token = torch.as_tensor(token, device=dev).long()
    B = token.shape[0]
    positions = pos[:, None]
    x = constrain(_embed_in(params, token[:, None], positions, cfg), ctx,
                  act_spec(ctx))
    n_rep = cfg.n_heads // cfg.n_kv_heads
    # the pages' tables and lengths once a step, on the device
    if on_mesh(ctx):
        slot, pages = None, mesh_decode(pos, S, n_rep, ctx, ring)
        B_rows = pages.rows.shape[0]
    else:
        slot = (torch.arange(B, device=dev), pos % S)
        pages = decode_pages(torch.clamp(pos + 1, max=S), S, n_rep)
        B_rows = B
    crosses = xpages = None
    if cfg.family in ("encdec", "vlm"):
        crosses = _cross_caches(cache)
        S_x = cache["cross_k"].shape[2]
        xpages = decode_pages(torch.full((B_rows,), S_x, device=dev), S_x,
                              n_rep)
    for (blk, has_cross), kv in zip(_blocks(params, cfg),
                                    _self_caches(cache, cfg)):
        xk, xv = next(crosses) if has_cross else (None, None)
        x, _ = block_apply(x, blk, cfg, positions=positions, cache=kv,
                           slot=slot, pos=pos, pages=pages, xk=xk, xv=xv,
                           xpages=xpages if has_cross else None, ctx=ctx)
    x = apply_norm(x, params["final_norm"], cfg.norm)
    return _unembed(params, x, cfg)[:, 0], cache


# ====================================================== JAX -> port params
def _leaf(a, device) -> torch.Tensor:
    """One numpy leaf -> tensor.  bf16 (which numpy holds as ml_dtypes'
    type) goes through f32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(x, device, index=()):
    """A pytree of numpy leaves -> tensors, each leaf taken at ``index``
    (the stacked layer axes)."""
    if isinstance(x, dict):
        return {k: _tree(v, device, index) for k, v in x.items()}
    return _leaf(np.asarray(x)[index], device)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX param pytree (leaves as numpy arrays, layers stacked on
    leading axes: ``blocks``, ``enc_blocks`` and ``dec_blocks`` on axis 0;
    ``groups`` on (G, inner) for vlm's ``self`` and G for its ``cross``,
    on (G, 7) for xlstm's ``m`` and G for its ``s``, on G for rglru's
    ``rec1``, ``rec2`` and ``attn``) -> the port's parameters, exactly."""
    n_layers = {"blocks": cfg.n_layers, "dec_blocks": cfg.n_layers,
                "enc_blocks": cfg.enc_layers}
    out = {}
    for key, sub in np_tree.items():
        if key in n_layers:
            out[key] = [_tree(sub, device, (i,))
                        for i in range(n_layers[key])]
        elif key == "groups":
            out[key] = _groups(sub, cfg, device)
        else:
            out[key] = _tree(sub, device)
    return out


def params_to_jax(tree):
    """The inverse of ``params_from_jax`` (and, on an ``AdamWState``, of
    ``optim.opt_state_from_jax``): the port's parameters, or any tree of
    its, -> the reference's stacked layout.  Every list of layers (a list
    of lists for vlm's ``self`` and xlstm's ``m``) becomes leading axes
    of each leaf below it; dicts and NamedTuples keep their structure.
    Each leaf is a host tensor over a fresh numpy buffer, bf16 over an
    int16 one (numpy has no bf16 without ml_dtypes), into whose slices
    the layers are copied one by one from their device: nothing is
    stacked on the card, and nothing of the result shares memory with
    ``tree``, which the optimizer updates in place.  A DTensor leaf is
    gathered whole first."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(params_to_jax(v) for v in tree))
    stacks: dict[tuple, list] = {}
    for path, index, leaf in _layer_leaves(tree):
        stacks.setdefault(path, []).append((index, torch.as_tensor(leaf)))
    if list(stacks) == [()]:
        return _host_stack(stacks[()])
    out: dict = {}
    for path, parts in stacks.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = _host_stack(parts)
    return out


def _layer_leaves(x, path=(), index=()):
    """(dict keys, list positions, leaf) of each leaf below ``x``."""
    if isinstance(x, dict):
        for k, v in x.items():
            yield from _layer_leaves(v, path + (k,), index)
    elif isinstance(x, list):
        for i, v in enumerate(x):
            yield from _layer_leaves(v, path, index + (i,))
    else:
        yield path, index, x


def _host_stack(parts: list) -> torch.Tensor:
    """[(layer index, tensor)] -> one host tensor over a new numpy buffer,
    each tensor copied into its slice (a copy from the card waits for
    it)."""
    first = parts[0][1]
    lead = tuple(max(ix[a] for ix, _ in parts) + 1
                 for a in range(len(parts[0][0])))
    if len(parts) != math.prod(lead):
        raise ValueError(f"layers of unequal structure: {len(parts)} "
                         f"leaves for a stack of {lead}")
    bf16 = first.dtype == torch.bfloat16
    np_dtype = (np.int16 if bf16
                else torch.empty((), dtype=first.dtype).numpy().dtype)
    host = torch.from_numpy(np.empty(lead + tuple(first.shape), np_dtype))
    host = host.view(torch.bfloat16) if bf16 else host
    for ix, t in parts:
        # a DTensor is gathered whole (a collective: every rank of its
        # mesh takes the same leaves in the same order)
        t = t.full_tensor() if isinstance(t, DTensor) else t
        host[ix].copy_(t.detach())
    return host


def decay_mask(params: dict, cfg: ModelConfig) -> dict:
    """AdamW's weight-decay mask over the port's parameters (any family):
    True where the leaf's counterpart in the reference's tree has ndim >=
    2, the reference's rule (``p.ndim >= 2``), counting the stack axes
    that ``params_from_jax`` turns into lists: 1 for ``blocks``,
    ``enc_blocks``, ``dec_blocks`` and the ``groups`` of vlm's ``cross``,
    xlstm's ``s`` and rglru; 2 for vlm's ``self`` and xlstm's ``m``.  So
    every per-layer norm scale and bias is decayed, as in the reference
    (a fault recorded in ROADMAP Queue 3), and ``final_norm`` is not."""
    inner = {"vlm": "self", "ssm": "m"}.get(cfg.family)

    def walk(tree, axes):
        if isinstance(tree, dict):
            return {k: walk(v, axes) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, axes) for v in tree]
        return tree.dim() + axes >= 2

    out = {}
    for key, sub in params.items():
        if key in ("blocks", "enc_blocks", "dec_blocks"):
            out[key] = walk(sub, 1)
        elif key == "groups":
            out[key] = [{k: walk(v, 2 if k == inner else 1)
                         for k, v in g.items()} for g in sub]
        else:
            out[key] = walk(sub, 0)
    return out


def _groups(sub: dict, cfg: ModelConfig, device) -> list:
    """The stacked ``groups`` of a vlm, xlstm or rglru tree -> a list of
    one dict per group; vlm's ``self`` and xlstm's ``m`` -> a list per
    group of its inner blocks."""
    def n(tree, axis):                     # a subtree's stacked length
        return np.asarray(next(_np_leaves(tree))).shape[axis]
    inner = {"vlm": "self", "ssm": "m"}.get(cfg.family)
    return [{k: ([_tree(v, device, (g, i)) for i in range(n(v, 1))]
                 if k == inner else _tree(v, device, (g,)))
             for k, v in sub.items()}
            for g in range(n(sub, 0))]


def _np_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _np_leaves(v)
    else:
        yield tree


def state_from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's decode state or cache (numpy leaves) -> the port's,
    which keeps its layout.  A RecurrentGemma ring that the reference's
    prefill left at fewer than W slots (a prompt shorter than the window:
    slots 0..T-1 hold positions 0..T-1) is padded with empty slots (pos
    -1) to the W-slot ring the port decodes over."""
    out = _tree(np_tree, device)
    if cfg.family == "hybrid":
        ring = out["groups"]["attn"]
        pad = cfg.attn_window - ring["k"].shape[2]
        if pad > 0:
            ring["k"], ring["v"] = (torch.nn.functional.pad(
                t, (0, 0, 0, 0, 0, pad)) for t in (ring["k"], ring["v"]))
            ring["pos"] = torch.nn.functional.pad(ring["pos"], (0, pad),
                                                  value=-1)
    return out
