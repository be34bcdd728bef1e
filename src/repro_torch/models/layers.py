"""Model primitives, as ``repro.models.layers``: norms, RoPE and
sinusoidal positions, the projections, decode attention over a contiguous
cache on the paged kernel, the MLP, the capacity-routed MoE block, and
parameter init.  Attention over a prompt is the flash kernel's
(``kernels.ops.flash_attention``), whose plain version is the CPU's.

On a mesh (a ``MeshCtx`` with a mesh; parameters and activations are
DTensors) each of the reference's ``shard_map`` regions is a
``local_map`` region over local tensors, the port's kernels and explicit
collectives: ``mesh_attention`` (heads over ``model``, or the query
sequence where the heads do not divide: the reference's
``sharded_attention``), ``mesh_decode_attend`` over an S-sharded cache
(the write on the shard that owns the slot, the paged kernel over each
shard's slots, the shards merged by log-sum-exp) and ``moe_apply``
(experts over ``model``, ZeRO-3 gathers over ``data``).  The recurrent
mixers' sharded bodies are ``local_map`` regions too, with the
collectives of ``ModelShard``.  With no mesh every function is the
single-device path.

Parameter layout follows the reference, so converted JAX parameters drop
in unchanged:

  attn:  wq (D, H*hd)   wk/wv (D, Hkv*hd)   wo (H*hd, D)   [+ bq/bk/bv]
  mlp:   wg/wu (D, F)   wd (F, D)           (gelu: wi (D, F), wd)
  moe:   router (D, E)  wg/wu (E, D, F)     wd (E, F, D)

Init draws from an explicit ``torch.Generator`` with ``init_lm``'s
distributions; parameters land on the generator's device.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from repro_torch.kernels.ops import flash_attention, paged_attention
from repro_torch.kernels.paged_attention import MAX_REP
from repro_torch.parallel.sharding import placements


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


def embed(table, tokens, ctx=None):
    """The rows of ``table`` (V, D) at ``tokens``.  ``F.embedding``, not an
    index: on a mesh DTensor has a rule for it over a vocab-sharded table
    (each rank looks up its rows, a masked partial sum), where an index
    gathers the table whole and its gradient's ``index_put`` fails to
    propagate on torch 2.11.  The tokens go to the activations' batch
    shards first, so the mask covers the rows each rank keeps."""
    if on_mesh(ctx):
        tokens = constrain(tokens, ctx, act_spec(ctx, tokens.dim()))
    return F.embedding(tokens, table)


def token_nll(logits, targets, ctx=None):
    """The next-token NLL at every position: logits (B, T, V), targets
    (B, T) -> (B, T).  On a mesh whose model axis divides V the logits
    stay split over ``model`` as the head's product leaves them, and each
    rank reduces its vocab shard (``vocab_nll``), as the reference's
    partitioned logsumexp does.  Elsewhere on a mesh (V that the axis
    does not divide, or no model axis) each rank takes its own batch rows
    whole in a ``local_map``: DTensor's backward of the gold logit's
    gather would build a zero tensor of the global (B, T, V) on every
    rank.  Logits split on T over ``model`` (the sequence-parallel
    forward's, whose head is whole over ``model``) stay so: each rank
    takes its own rows.  A whole vocab goes through ``whole_nll``."""
    targets = torch.as_tensor(targets, device=logits.device)
    if on_mesh(ctx):
        b = _bspec(ctx)
        if on_rows(logits, ctx):
            rows = row_spec(ctx, 2)
            return _local(whole_nll, ctx, (rows + (None,), rows), rows)(
                logits, constrain(targets, ctx, rows))
        targets = constrain(targets, ctx, (b, None))
        sh = model_shard(ctx, logits.shape[-1])
        if sh is not None:
            return _local(lambda l, t: vocab_nll(l, t, sh), ctx,
                          ((b, None, ctx.model_axis), (b, None)),
                          (b, None))(logits, targets)
        return _local(whole_nll, ctx, ((b, None, None), (b, None)),
                      (b, None))(logits, targets)
    return whole_nll(logits, targets)


# the logits' elements a chunk of ``whole_nll``'s rows spans (64 MB in f32)
NLL_CHUNK = 1 << 24


def whole_nll(logits, targets):
    """logsumexp over the whole vocab less the gold logit: logits (..., V),
    targets (...) -> (...), by ``_WholeNLL`` over chunks of
    ``NLL_CHUNK`` elements' worth of rows (at least one row)."""
    return _WholeNLL.apply(logits, targets.long(),
                           max(1, NLL_CHUNK // logits.shape[-1]))


class _WholeNLL(torch.autograd.Function):
    """``torch.logsumexp(l, -1) - l[target]`` and the gradient autograd
    gives it, g exp(l - lse) less g at the target, taken over chunks of
    rows: it keeps the logits and the log-sum-exp only and recomputes each
    chunk's exponent in the backward, so at most one chunk's exponent is
    live where the eager expression holds the whole (..., V) one.
    ``_VocabNLL`` without the collectives."""

    @staticmethod
    def forward(ctx_, lg, t, rows):
        flat = lg.reshape(-1, lg.shape[-1])
        lse = torch.cat([torch.logsumexp(c, dim=-1)
                         for c in flat.split(rows)])
        ctx_.save_for_backward(lg, t, lse)
        ctx_.rows = rows
        return (lse - flat.gather(-1, t.reshape(-1, 1))[:, 0]).view(t.shape)

    @staticmethod
    def backward(ctx_, g):
        lg, t, lse = ctx_.saved_tensors
        flat, g = lg.reshape(-1, lg.shape[-1]), g.reshape(-1, 1)
        grad = torch.empty_like(flat)
        for i in range(0, flat.shape[0], ctx_.rows):
            s = slice(i, i + ctx_.rows)
            torch.mul(g[s], (flat[s] - lse[s, None]).exp(), out=grad[s])
        grad.scatter_add_(-1, t.reshape(-1, 1), -g)
        return grad.view_as(lg), None, None


def vocab_nll(logits, targets, sh: ModelShard):
    """Inside a ``local_map`` region: the NLL of targets (B_l, T) from this
    rank's vocab shard of the logits (B_l, T, V / tp), in f32: each
    rank's gold logit, 0 where the target lies in another rank's shard,
    into ``_VocabNLL``."""
    lg = logits.float()
    V_l = lg.shape[-1]
    t = targets.long() - sh.rank * V_l
    mine = (t >= 0) & (t < V_l)
    gold = lg.gather(-1, t.clamp(0, V_l - 1)[..., None])[..., 0]
    return _VocabNLL.apply(lg, torch.where(mine, gold, 0.0), sh.group)


class _VocabNLL(torch.autograd.Function):
    """logsumexp over the vocab shards of ``group`` less the gold logit:
    each rank's shard (B_l, T, V / tp) and gold part (B_l, T) -> the NLL
    (B_l, T), whole on every rank.  ``torch.logsumexp``'s arithmetic: the
    row max (an all-reduce MAX), the sum of exp(l - max) and the gold
    parts (one all-reduce SUM), log + max; its gradient exp(l - lse),
    recomputed from the logits, so no exponent is kept.  The NLL is whole
    over ``model``, so each rank's gradient of it is already the whole
    one: it passes to the gold part as it is, not summed over ranks
    (which would multiply it by tp)."""

    @staticmethod
    def forward(ctx_, lg, gold, group):
        m = lg.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        sums = torch.stack([torch.exp(lg - m[..., None]).sum(dim=-1), gold])
        dist.all_reduce(sums, group=group)
        lse = sums[0].log() + m
        ctx_.save_for_backward(lg, lse)
        return lse - sums[1]

    @staticmethod
    def backward(ctx_, g):
        lg, lse = ctx_.saved_tensors
        return g[..., None] * (lg - lse[..., None]).exp(), -g, None


def check_decode_positions(pos, filled, S: int, ring: bool) -> None:
    """Before a decode step writes anything: ``pos`` (B,) the step's
    positions, ``filled`` (B,) each row's count of valid slots, both on
    the device and read in one transfer a step.  Raises IndexError on a
    position below 0, or at or past S where the cache is no ring (the
    reference drops such a write, ROADMAP Queue 3 item 2), and ValueError
    where a row does not hold exactly its positions before pos, min(pos,
    S) of them in a ring: past them the paged kernel would read
    never-written slots that the reference masks out.  Fake tensors (a
    trace under ``FakeTensorMode``: the dry run) hold no positions to
    read, and pass."""
    if is_fake(pos) or is_fake(filled):
        return
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


# ------------------------------------------------------------------ the mesh
def on_mesh(ctx) -> bool:
    return ctx is not None and ctx.mesh is not None


@contextlib.contextmanager
def mesh_scope(ctx):
    """The context the model runs in: on a mesh, DTensor's implicit
    replication (a tensor that is no DTensor, as positions or RoPE's
    frequencies, counts as whole on every rank); else nothing.  A scope
    opened inside another leaves it to the outer one
    (``implicit_replication`` turns the replication off on any exit, and
    a train step's backward runs after the loss's scope closes, inside
    the step's)."""
    if not on_mesh(ctx) or DTensor._op_dispatcher._allow_implicit_replication:
        yield
        return
    with implicit_replication():
        yield


def _bspec(ctx):
    return ctx.batch_axes if on_mesh(ctx) and ctx.batch_axes else None


def act_spec(ctx, nd: int = 3) -> tuple:
    """The activations' spec: the batch over the DP axes, the rest whole."""
    return (_bspec(ctx),) + (None,) * (nd - 1)


def row_spec(ctx, nd: int = 3) -> tuple:
    """The sequence-parallel activations' spec: the batch over the DP
    axes, the positions (dim 1) over ``model``, the rest whole."""
    return (_bspec(ctx), ctx.model_axis) + (None,) * (nd - 2)


def sequence_parallel(cfg, T: int, ctx) -> bool:
    """Whether a mesh training forward over T positions runs its blocks
    sequence-parallel (``transformer.block_rows``): a model axis of more
    than one rank that the heads do not divide and T does, the condition
    of ``mesh_attention``'s query-sharded branch, which the reference's
    partition carries on through the block.  A MoE block keeps the
    tensor-parallel layout: its experts over ``model`` take every token."""
    if not on_mesh(ctx) or not ctx.model_axis or cfg.moe is not None:
        return False
    tp = ctx.size(ctx.model_axis)
    return cfg.n_heads % tp != 0 and T % tp == 0


def on_rows(t, ctx) -> bool:
    """Whether ``t`` is a DTensor split on dim 1 over ``model``: the
    sequence-parallel forward's residual or logits."""
    if not isinstance(t, DTensor) or not on_mesh(ctx) or not ctx.model_axis:
        return False
    i = ctx.mesh.mesh_dim_names.index(ctx.model_axis)
    return t.placements[i] == Shard(1)


class _Constrain(torch.autograd.Function):
    """A DTensor redistributed to the placements ``pl``; its gradient
    goes back to the input's placements (a partial sum's as whole), and a
    gradient that arrives as a partial sum (a column-parallel product's
    input gradient) is reduced here, as GSPMD reduces it at the
    constraint.  Left partial, DTensor would carry it down the residual
    stream and meet it at each product by gathering the weight whole, a
    product tp times the size of the rank's share."""

    @staticmethod
    def forward(ctx_, x, mesh, pl):
        ctx_.mesh = mesh
        ctx_.src = tuple(Replicate() if q.is_partial() else q
                         for q in x.placements)
        return x.view_as(x) if tuple(x.placements) == pl \
            else x.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx_, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx_.src:
            g = g.redistribute(ctx_.mesh, ctx_.src)
        return g, None, None


def constrain(x, ctx, spec: tuple):
    """``x`` redistributed to ``spec`` on the mesh (the counterpart of
    ``with_sharding_constraint``; a tensor that is no DTensor is taken as
    whole on every rank), its gradient back to ``x``'s placements with a
    partial sum reduced (``_Constrain``); ``x`` itself off the mesh."""
    if not on_mesh(ctx):
        return x
    pl = placements(spec, ctx.mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, ctx.mesh, [Replicate()] * len(pl),
                               run_check=False)
    if not x.requires_grad:
        return x if tuple(x.placements) == pl \
            else x.redistribute(ctx.mesh, pl)
    return _Constrain.apply(x, ctx.mesh, pl)


def _pl(ctx, spec, partial: tuple = ()):
    """A spec's placements as a list (``local_map``'s form for one tensor),
    ``Partial()`` on the mesh axes named in ``partial``; None stays None."""
    if spec is None:
        return None
    pl = list(placements(spec, ctx.mesh))
    for i, name in enumerate(ctx.mesh.mesh_dim_names):
        if name in partial:
            pl[i] = Partial()
    return pl


def _local(fn, ctx, in_specs, out_specs, grad_partial=None,
           out_partial: tuple = ()):
    """``local_map`` of ``fn`` over ``ctx.mesh``: the DTensor inputs
    redistributed to ``in_specs`` (None for an input that is no DTensor),
    the outputs of ``out_specs`` (a list for several; the first a partial
    sum over the mesh axes named in ``out_partial``).  ``grad_partial``:
    per input, the mesh axes over which its gradient is a partial sum (an
    input whole there whose ranks each use a part of it).  An input that
    is None passes as None."""
    if isinstance(out_specs, list):
        outs = tuple(_pl(ctx, s, out_partial if i == 0 else ())
                     for i, s in enumerate(out_specs))
    else:
        outs = _pl(ctx, out_specs, out_partial)

    def call(*args):
        specs = [None if a is None else s for a, s in zip(args, in_specs)]
        gp = None
        if grad_partial is not None:
            gp = tuple(_pl(ctx, s, part) for s, part in zip(specs,
                                                              grad_partial))
        return local_map(fn, out_placements=outs,
                         in_placements=tuple(_pl(ctx, s) for s in specs),
                         in_grad_placements=gp, device_mesh=ctx.mesh,
                         redistribute_inputs=True)(*args)
    return call


def heads(t, n: int, hd: int, ctx=None):
    """(B, T, n * hd) -> (B, T, n, hd).  On a mesh a flat axis sharded over
    ``model`` whose head count does not divide it (qwen's 2 kv heads at tp
    4) is redistributed whole over ``model`` first: DTensor cannot split a
    shard across the (n, hd) reshape."""
    B, T = t.shape[:2]
    if on_mesh(ctx) and ctx.model_axis and n % ctx.size(ctx.model_axis):
        t = constrain(t, ctx, act_spec(ctx))
    return t.reshape(B, T, n, hd)


def head_split(H: int, Hkv: int, ctx):
    """This rank's kv heads where the H query heads divide the model axis
    and K/V stay whole over it: (first kv head, count) of those its H / tp
    query heads read, a whole number of kv heads or one kv head for
    several ranks; None where neither holds."""
    ax, tp = ctx.model_axis, ctx.size(ctx.model_axis)
    if not ax or H % tp:
        return None
    H_l, n_rep = H // tp, H // Hkv
    if H_l % n_rep and n_rep % H_l:
        return None
    return ctx.rank(ax) * H_l // n_rep, max(1, H_l // n_rep)


class _ContiguousGrad(torch.autograd.Function):
    """x itself; its gradient made contiguous.  The flash backward's dV is
    (B, H, T, hd) in memory; left so, DTensor cannot view the partial
    gradient as (B, T, H * hd) and reduce-scatters it over T instead, and
    where T does not divide the model axis the uneven shards come back
    strided into the projection's backward, which views them flat."""

    @staticmethod
    def forward(ctx_, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx_, g):
        return g.contiguous()


class _PadRows(torch.autograd.Function):
    """x (B, T, ...) followed by ``pad`` rows of zeros; its gradient the
    first T rows of the padded one's, contiguous (a product's backward
    views its saved input flat, which a strided slice refuses)."""

    @staticmethod
    def forward(ctx_, x, pad):
        ctx_.T = x.shape[1]
        return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))

    @staticmethod
    def backward(ctx_, g):
        return g[:, :ctx_.T].contiguous(), None


def mesh_attention(q, k, v, ctx, *, causal: bool = True, window: int = 0):
    """Attention over a prompt on a mesh: the flash kernel on each rank's
    local rows.  q: (B, T, H, hd); k, v: (B, S, Hkv, hd), DTensors.

    * H divides the model axis: each rank takes its heads (the reference's
      GSPMD partition by head), and its share of the kv heads where Hkv
      divides too; else K/V stay whole over ``model`` and each rank takes
      the kv heads its query heads read, where that is a whole number of
      kv heads, or one kv head for several ranks.
    * H does not divide: the reference's ``sharded_attention``, the query
      sequence over ``model`` (T / tp rows a rank, the flash kernel's
      ``q_offset`` their first position), K/V whole.  Where tp does not
      divide T either (whisper's encoder, 1500 frames on 16), q is padded
      to ceil(T / tp) rows a rank, the last rank's padding computed and
      dropped after the rows are gathered whole.
    * A mesh with no model axis: every rank computes every head (q, K and
      V whole)."""
    ax, tp, b = ctx.model_axis, ctx.size(ctx.model_axis), _bspec(ctx)
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    whole = (b, None, None, None)
    by_head = (b, None, ax, None)
    r = ctx.rank(ax)
    part = (ax,) if ax else ()

    def flash(q_l, k_l, v_l, q_offset=0):
        return flash_attention(q_l.contiguous(), k_l.contiguous(),
                               v_l.contiguous(), causal=causal,
                               window=window, q_offset=q_offset)

    if ax and H % tp == 0:
        if Hkv % tp == 0:
            return _local(flash, ctx, (by_head,) * 3, by_head)(q, k, v)
        split = head_split(H, Hkv, ctx)
        if split is not None:
            lo, n_kv = split
            return _local(lambda q_l, k_l, v_l: flash(
                q_l, k_l[:, :, lo:lo + n_kv], v_l[:, :, lo:lo + n_kv]),
                ctx, (by_head, whole, whole), by_head,
                grad_partial=((), part, part))(q, k, v)
    elif ax:
        by_row, n = (b, ax, None, None), -(-T // tp)
        pad = n * tp - T
        if pad:
            q = _local(lambda q_l: _PadRows.apply(q_l, pad), ctx, (whole,),
                       whole)(q)
        out = _local(lambda q_l, k_l, v_l: flash(
            q_l, _ContiguousGrad.apply(k_l), _ContiguousGrad.apply(v_l),
            r * n), ctx, (by_row, whole, whole), by_row,
            grad_partial=((), part, part))(q, k, v)
        if not pad:
            return out
        # the rows gathered whole, the padding dropped on each rank
        return _local(lambda o: o[:, :T].contiguous(), ctx, (whole,),
                      whole)(constrain(out, ctx, whole))
    return _local(flash, ctx, (whole,) * 3, whole)(q, k, v)


def rows_attention(q, k, v, sh: ModelShard, *, causal: bool = True,
                   window: int = 0):
    """Inside a sequence-parallel block (``transformer.block_rows``): the
    flash kernel over this rank's rows of the queries, q (B_l, T / tp, H,
    hd), against the keys and values of every rank's rows, k and v (B_l,
    T / tp, Hkv, hd) gathered over T (an all-gather; their gradients a
    reduce-scatter).  ``q_offset`` is the rows' first position."""
    return flash_attention(q, sh.gather(k, 1), sh.gather(v, 1),
                           causal=causal, window=window,
                           q_offset=sh.rank * q.shape[1])


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tmap(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def whole_over_model(fn, ctx, x, p, *rest):
    """``fn(x, p, *rest)`` on each rank's local tensors, with its batch
    rows and every parameter whole: a recurrent mixer on a mesh whose
    model axis does not divide its channels (the RG-LRU's R, the xLSTM's
    head width) or that has no model axis; where it divides, the mixer
    runs split over ``model`` (``models/rglru.py`` ``rec_mixer_mesh``,
    ``models/xlstm.py`` ``mlstm_mesh`` and ``slstm_mesh``).  ``x`` and
    the tensors of ``rest`` (states, or None) have the batch first and go
    to the activations' spec; the parameters of ``p`` go whole over the
    mesh (an all-gather of those sharded over ``model``), their gradient a
    partial sum over the DP axes.  Every rank of the model axis computes
    the same thing.  The outputs come back with the activations' spec."""
    mesh = ctx.mesh
    whole = [Replicate()] * mesh.ndim
    grad = [Partial() if n in ctx.batch_axes else Replicate()
            for n in mesh.mesh_dim_names]

    def param(t):
        if not isinstance(t, DTensor):
            return t
        return t.redistribute(mesh, whole).to_local(grad_placements=grad)

    def act(t):
        return constrain(t, ctx, act_spec(ctx, t.dim())).to_local()

    out = fn(_tmap(act, x), _tmap(param, p), *(_tmap(act, r) for r in rest))
    return _tmap(lambda t: DTensor.from_local(
        t, mesh, placements(act_spec(ctx, t.dim()), mesh),
        run_check=False), out)


class _WholeOverModel(torch.autograd.Function):
    """A DTensor parameter gathered whole over mesh dim ``i`` (the model
    axis; an all-gather where it is split there).  Each rank uses it on
    its own rows, so its gradient arrives a partial sum there: it is
    all-reduced, then cut back to the parameter's shard, as the
    reference's partition reduces a weight it gathered whole (a
    reduce-scatter would move 1 / tp of the bytes: ROADMAP, Parked)."""

    @staticmethod
    def forward(ctx_, w, mesh, i):
        ctx_.mesh, ctx_.i, ctx_.src = mesh, i, w.placements[i]
        pl = list(w.placements)
        pl[i] = Replicate()
        return w.view_as(w) if tuple(pl) == tuple(w.placements) \
            else w.redistribute(mesh, pl)

    @staticmethod
    def backward(ctx_, g):
        pl = list(g.placements)
        pl[ctx_.i] = Replicate()
        g = g.redistribute(ctx_.mesh, pl)
        pl[ctx_.i] = ctx_.src
        return g.redistribute(ctx_.mesh, pl), None, None


def whole_params(p, ctx):
    """The DTensor parameters of the tree ``p`` as local tensors whole over
    ``model`` (``_WholeOverModel``), for a rank that applies them to its
    own rows of the batch's rows: their gradients are partial sums over
    ``model`` and the DP axes.  The parameters of a block with no MoE are
    split over ``model`` only."""
    mesh = ctx.mesh
    i = mesh.mesh_dim_names.index(ctx.model_axis)
    grad = [Partial() if n in ctx.batch_axes or n == ctx.model_axis
            else Replicate() for n in mesh.mesh_dim_names]
    return _tmap(lambda t: _WholeOverModel.apply(t, mesh, i).to_local(
        grad_placements=grad) if isinstance(t, DTensor) else t, p)


class _SumOverModel(torch.autograd.Function):
    """Each rank's partial sum over ``group``, whole on every rank.  Each
    rank's use of the sum is its own part of the loss, so the gradient is
    summed the same way."""

    @staticmethod
    def forward(ctx_, x, group):
        ctx_.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx_, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx_.group)
        return g, None


class _AllGather(torch.autograd.Function):
    """Every rank's ``t`` concatenated along dim 0 over ``group``, in rank
    order; its gradient each rank's part of the gradients' sum (a
    reduce-scatter).  The functional collectives' autograd gather, with
    the gradient made contiguous first: a gather along another dim
    (``all_gather``) receives a strided one, which torch 2.11's
    reduce-scatter refuses ("Expected input.is_contiguous()"; 2.13 makes
    it contiguous itself)."""

    @staticmethod
    def forward(ctx_, t, group):
        ctx_.n, ctx_.name = group.size(), group.group_name
        c10d = torch.ops._c10d_functional
        return c10d.wait_tensor(c10d.all_gather_into_tensor(t, ctx_.n,
                                                            ctx_.name))

    @staticmethod
    def backward(ctx_, g):
        c10d = torch.ops._c10d_functional
        return c10d.wait_tensor(c10d.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx_.n, ctx_.name)), None


def all_gather(t, dim: int, group):
    """Every rank's ``t`` concatenated along ``dim`` over ``group`` in rank
    order (an all-gather; its gradient a reduce-scatter)."""
    t = t.movedim(dim, 0).contiguous()
    return _AllGather.apply(t, group).movedim(0, dim)


@dataclass(frozen=True)
class ModelShard:
    """Inside a ``local_map`` region, this rank's place on the model axis
    and its collectives there, with gradients: the recurrent mixers'
    sharded bodies (``models/rglru.py``, ``models/xlstm.py``)."""
    rank: int
    size: int
    group: object

    def cols(self, n: int) -> slice:
        """This rank's contiguous n / size of n channels."""
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def gather(self, t, dim: int = -1):
        """Every rank's ``t`` concatenated along ``dim`` in rank order (an
        all-gather; its gradient a reduce-scatter)."""
        return all_gather(t, dim, self.group)

    def sum(self, *ts):
        """The partial sums ``ts``, each summed over the ranks: one
        all-reduce for all of them."""
        flat = _SumOverModel.apply(torch.cat([t.reshape(-1) for t in ts]),
                                   self.group)
        return tuple(f.view_as(t) for f, t in zip(
            flat.split_with_sizes([t.numel() for t in ts]), ts))


def model_shard(ctx, n: int) -> ModelShard | None:
    """The ``ModelShard`` of this rank where the mesh has a model axis and
    it divides n, else None."""
    if not on_mesh(ctx) or not ctx.model_axis:
        return None
    tp = ctx.size(ctx.model_axis)
    if n % tp:
        return None
    return ModelShard(ctx.rank(ctx.model_axis), tp,
                      ctx.group(ctx.model_axis))


def fill_cache_shard(kv, k, v, positions, T: int, n: int, S: int, ctx) -> None:
    """A prefill's last n of T keys, values and positions into one
    layer's cache on a mesh, position p in slot p % S: each rank writes
    the slots of its own shard of S (all of them where S does not divide
    the model axis), IN PLACE."""
    tp = ctx.size(ctx.model_axis)
    sharded = bool(ctx.model_axis) and S % tp == 0
    S_l = S // tp if sharded else S
    lo = ctx.rank(ctx.model_axis) * S_l if sharded else 0
    js = [j for j in range(T - n, T) if lo <= j % S < lo + S_l]
    dev = positions.device
    src = torch.tensor(js, dtype=torch.long, device=dev)
    dst = torch.tensor([j % S - lo for j in js], dtype=torch.long,
                       device=dev)
    b = act_spec(ctx, 2)[0]
    s_ax = ctx.model_axis if sharded else None

    def f(ck, cv, cp, k_l, v_l, p_l):
        ck[:, dst] = k_l[:, src].to(ck.dtype)
        cv[:, dst] = v_l[:, src].to(cv.dtype)
        cp[:, dst] = p_l[:, src].to(cp.dtype)

    cache_kv, whole = (b, s_ax, None, None), (b, None, None, None)
    _local(f, ctx, (cache_kv, cache_kv, (b, s_ax), whole, whole, (b, None)),
           None)(kv["k"], kv["v"], kv["pos"], k, v,
                 constrain(positions, ctx, (b, None)))


@dataclass(frozen=True)
class MeshDecode:
    """One decode step's view of a cache from this rank: its batch rows'
    slot (``idx`` within this shard, clamped, and whether this shard owns
    it, ``owns``), their positions, and the pages of this shard's slots
    over each row's local length, clamp(len - rank * S / tp, 0, S / tp)
    (the valid slots are a prefix of the cache, a ring's too).  ``sharded``:
    the cache's S is split over ``model`` (else each rank holds it
    whole)."""
    rows: torch.Tensor         # (B_l,) 0..B_l - 1
    idx: torch.Tensor          # (B_l,)
    owns: torch.Tensor         # (B_l,) bool
    pos: torch.Tensor          # (B_l,)
    pages: DecodePages
    sharded: bool


def mesh_decode(pos, S: int, n_rep: int, ctx, ring: bool) -> MeshDecode:
    """``pos`` (B,) the step's positions, whole on every rank."""
    tp = ctx.size(ctx.model_axis)
    sharded = bool(ctx.model_axis) and S % tp == 0
    S_l, r = (S // tp, ctx.rank(ctx.model_axis)) if sharded else (S, 0)
    i, n = ctx.batch_shards()
    B_l = pos.shape[0] // n
    pos_l = pos[i * B_l:(i + 1) * B_l]
    slot = (pos_l % S if ring else pos_l) - r * S_l
    lens = torch.clamp(torch.clamp(pos_l + 1, max=S) - r * S_l, 0, S_l)
    return MeshDecode(torch.arange(B_l, device=pos.device),
                      torch.clamp(slot, 0, S_l - 1),
                      (slot >= 0) & (slot < S_l), pos_l,
                      decode_pages(lens, S_l, n_rep), sharded)


def _merge_shards(out, lse, group):
    """Rows that hold disjoint parts of one sequence, merged over
    ``group`` by their log-sum-exps: out (R, H, hd), lse (R, H) f32 ->
    sum_r exp(lse_r - max) out_r / sum_r exp(lse_r - max), an all-reduce
    of the max and one of the weighted sums.  A shard with no valid slot
    has lse -inf and weighs 0."""
    m = lse.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    w = torch.exp(lse - m)
    both = torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)
    dist.all_reduce(both, group=group)
    return (both[..., :-1] / both[..., -1:]).to(out.dtype)


def mesh_decode_attend(q, cache_k, cache_v, cache_pos, new_k, new_v,
                       step: MeshDecode, ctx):
    """The reference's ``decode_update_and_attend`` on a mesh, a
    ``local_map`` over the cache's shards: the new token's K/V and
    position are written IN PLACE on the shard that owns the slot (the
    others write back what they hold), each shard runs the paged kernel
    over its own slots with the rows' log-sum-exps, and the shards are
    merged (``_merge_shards``).  q (B, 1, H, hd) and new_k/v (B, 1, Hkv,
    hd) whole over ``model``; cache_k/v (B, S, Hkv, hd) and cache_pos
    (B, S) with S over ``model`` where ``step.sharded`` -> (B, 1, H, hd)."""
    b, ax = _bspec(ctx), ctx.model_axis
    s_ax = ax if step.sharded else None
    whole = (b, None, None, None)
    kv = (b, s_ax, None, None)

    def f(q_l, k_l, v_l, cp_l, nk_l, nv_l):
        at, own = (step.rows, step.idx), step.owns
        k_l[at] = torch.where(own[:, None, None], nk_l[:, 0].to(k_l.dtype),
                              k_l[at])
        v_l[at] = torch.where(own[:, None, None], nv_l[:, 0].to(v_l.dtype),
                              v_l[at])
        cp_l[at] = torch.where(own, step.pos.to(cp_l.dtype), cp_l[at])
        pages = step.pages
        Bl, _, H, hd = q_l.shape
        Hkv = k_l.shape[2]
        split, r = pages.split, H // Hkv // pages.split
        out, lse = paged_attention(
            *paged_view(q_l.contiguous(), k_l, v_l, pages), pages.table,
            pages.lens, return_lse=True)
        if step.sharded:
            out = _merge_shards(out, lse, ctx.group(ax))
        return out.view(Bl, split, Hkv, r, hd).transpose(1, 2) \
            .reshape(Bl, 1, H, hd)

    return _local(f, ctx, (whole, kv, kv, (b, s_ax), whole, whole),
                  whole)(q, cache_k, cache_v, cache_pos, new_k, new_v)


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


def moe_local(x, router, wg, wu, wd, *, top_k: int, capacity: int,
              expert_offset: int = 0):
    """Token-choice routing with per-expert top-C capacity over the
    scores, the experts' SwiGLU on the gathered tokens, then each token's
    sum over its k experts.  x: (T, D); wg/wu: (E_l, D, F); wd: (E_l, F,
    D), the router's experts ``expert_offset`` .. ``expert_offset + E_l -
    1`` -> their partial output (T, D).  Tokens an expert does not route
    score 0; where C exceeds the routed count, the zero-gate tokens picked
    add exactly nothing, so they are left out of the sum."""
    T, D = x.shape
    E = wg.shape[0]
    logits = (x @ router.to(x.dtype)).float()                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(probs, top_k, dim=-1)                  # (T, k)
    topw = topw / (topw.sum(dim=-1, keepdim=True) + 1e-9)
    hit = topi[:, :, None] == torch.arange(
        expert_offset, expert_offset + E, device=x.device)         # (T, k, E)
    score = torch.where(hit, topw[:, :, None], 0.0).sum(dim=1)     # (T, E)
    gate, idx = capacity_top_k(score.T, capacity)                  # (E, C)
    xe = x[idx]                                                    # (E, C, D)
    h = silu(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    ye = torch.bmm(h, wd)
    ye = ye * gate[..., None].to(ye.dtype)
    if E < router.shape[-1]:          # a part of the experts: number them
        topi = topi - expert_offset   # locally, E for one held elsewhere
        topi = topi.where((topi >= 0) & (topi < E), E)
    return combine_top_k(ye, idx, topi, T)


def combine_top_k(ye, idx, topi, T: int):
    """out[t] = sum over j < k of ye[topi[t, j], the slot of t there]:
    ye (E, C, D) the experts' gated outputs, idx (E, C) the token in each
    slot, topi (T, k) each token's experts (E, or an expert not holding t
    in its C slots, adds nothing).  A gather and a sum in a fixed order:
    a scatter-add (``index_add_``) adds a token's k outputs with atomics
    in no fixed order on the card, and in bf16 the rounding follows the
    order (two runs of moonshot-v1-16b-a3b at full width gave different
    greedy tokens)."""
    E, C, D = ye.shape
    # each token's first slot in each expert, C where it holds none (its
    # routed tokens fill an expert's first slots; a later slot of the
    # same token could only be one of gate 0).  The least of the writes
    # is kept, whatever order they land in
    slot = torch.full((T, E + 1), C, dtype=torch.long, device=ye.device)
    slot.scatter_reduce_(0, idx.T, torch.arange(C, device=ye.device)[
        :, None].expand(C, E), "amin")
    rows = torch.add(slot.gather(1, topi), topi, alpha=C + 1)      # (T, k)
    ye = F.pad(ye, (0, 0, 0, 1, 0, 1))      # expert E and slot C: zeros
    return ye.reshape(-1, D).index_select(0, rows.reshape(-1)).reshape(
        T, -1, D).sum(dim=1)


def moe_capacity(n_tokens: int, top_k: int, n_experts: int, cf: float) -> int:
    c = int(math.ceil(n_tokens * top_k / n_experts * cf))
    c = max(c, min(4, n_tokens))       # decode floor: tiny T, skewed routing
    return max(1, min(n_tokens, c))


class _SumOverRanks(torch.autograd.Function):
    """The sum of each rank's part over ``group``, whole on every rank;
    its gradient is the output's, which every rank holds whole."""

    @staticmethod
    def forward(ctx_, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx_, g):
        return g, None


# calls of ``moe_apply``'s mesh branch, for the chip smoke to count
MOE_MESH_CALLS = [0]


def moe_apply(x, p, moe_cfg, ctx=None):
    """x: (B, T, D).  Off the mesh every expert is local.  On a mesh the
    experts are split over ``model`` (the tokens whole there): each rank
    runs its E / tp experts from offset rank * E / tp and an all-reduce
    sums the outputs; with ``data`` > 1 and F divisible by it, the expert
    weights are stored sharded over ``data`` on F (ZeRO-3, as
    ``parallel.sharding``'s rule) and all-gathered per layer."""
    B, T, D = x.shape
    E, k, cf = moe_cfg.n_experts, moe_cfg.top_k, moe_cfg.capacity_factor
    if not on_mesh(ctx):
        out = moe_local(x.reshape(-1, D), p["router"], p["wg"], p["wu"],
                        p["wd"], top_k=k,
                        capacity=moe_capacity(B * T, k, E, cf))
        return out.reshape(B, T, D)
    ax, tp = ctx.model_axis, ctx.size(ctx.model_axis)
    if ax is None or E % tp:
        raise ValueError(f"{E} experts over a model axis of {tp} (axis "
                         f"{ax!r})")
    F_ = p["wg"].shape[-1]
    dp = ctx.size("data")
    fsdp = "data" if dp > 1 and F_ % dp == 0 else None
    b = _bspec(ctx)
    off = ctx.rank(ax) * (E // tp)
    MOE_MESH_CALLS[0] += 1

    def f(xl, router, wg, wu, wd):
        if fsdp is not None:
            # ZeRO-3 gather: this layer's expert shard, whole
            grp = ctx.group(fsdp)
            wg = all_gather(wg, 2, grp)
            wu = all_gather(wu, 2, grp)
            wd = all_gather(wd, 1, grp)
        Bl, Tl = xl.shape[:2]
        out = moe_local(xl.reshape(-1, D), router, wg, wu, wd, top_k=k,
                        capacity=moe_capacity(Bl * Tl, k, E, cf),
                        expert_offset=off)
        return _SumOverRanks.apply(out, ctx.group(ax)).reshape(Bl, Tl, D)

    # gradients that are partial sums: the tokens' over the experts'
    # ranks; the router's over those and the batch's; the experts' over
    # the batch's, unless the ZeRO-3 gather's reduce-scatter sums them
    dp_axes = tuple(ctx.batch_axes)
    w_part = () if fsdp else dp_axes
    return _local(
        f, ctx, ((b, None, None), (None, None), (ax, None, fsdp),
                 (ax, None, fsdp), (ax, fsdp, None)), (b, None, None),
        grad_partial=((ax,), (ax,) + dp_axes, w_part, w_part, w_part))(
        x, p["router"], p["wg"], p["wu"], p["wd"])


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


def qkv_proj(x, p, n_heads: int, n_kv: int, hd: int, ctx=None):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (heads(q, n_heads, hd, ctx), heads(k, n_kv, hd, ctx),
            heads(v, n_kv, hd, ctx))


def out_proj(attn_out, p, ctx=None):
    """(B, T, H, hd) -> (B, T, D).  On a mesh whose model axis the head
    count does not divide (``heads``'s counterpart), the flat heads go
    through a constraint: the gradient of the row-parallel product comes
    back sharded on the flat axis, and DTensor cannot split that shard
    across the (H, hd) reshape, so the constraint's backward gathers it
    whole first.  Its forward shards the flat axis over ``model`` where it
    divides, as the product takes it."""
    B, T, H = attn_out.shape[:3]
    flat = attn_out.reshape(B, T, -1)
    if on_mesh(ctx) and ctx.model_axis:
        tp = ctx.size(ctx.model_axis)
        if H % tp:
            ax = ctx.model_axis if flat.shape[-1] % tp == 0 else None
            flat = constrain(flat, ctx, act_spec(ctx, 2) + (ax,))
    return flat @ p["wo"]
