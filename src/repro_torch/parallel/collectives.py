"""Data-parallel gradient collectives, as ``repro.parallel.collectives``,
on ``torch.distributed`` process groups of the mesh's axes.

  * **int8-compressed gradient all-reduce** — a ring reduce-scatter /
    all-gather where every hop ships int8 and one f32 scale (per-tensor
    symmetric quantisation of the chunk sent), built from
    ``dist.batch_isend_irecv`` over the group of the data axis.
  * **hierarchical mean** — a mean over each DP axis in turn, innermost
    first.
  * **broadcast_object** — rank 0's Python value on every rank (a step
    number, a flag), where the world has more than one rank.

As in the reference, ``compressed_allreduce_tree`` takes gradients that
are already the exact mean (the loss is the global batch's mean, so every
rank holds the same gradient) and rings over those identical copies: it
adds quantisation error and traffic and replaces no reduction.  That is
the reference's arithmetic, kept (ROADMAP Queue 3).  The quantisation is
plain torch ops, as it is plain jnp in the reference.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def _quantize_int8(x):
    """Symmetric per-tensor int8 quantisation -> (q, scale (1,) f32).  127
    is divided by as a tensor, as the reference's XLA division does (a
    Python divisor may become a multiply by its reciprocal on the card)."""
    amax = x.abs().max().reshape(1) + 1e-12
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize_int8(q, scale):
    return q.float() * scale


def _shift(tensors, group, me: int, n: int) -> list:
    """Send each of ``tensors`` to the next rank of ``group`` and receive
    the previous rank's, in one ``batch_isend_irecv``."""
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)
    bufs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors] + \
        [dist.P2POp(dist.irecv, b, prv, group) for b in bufs]
    for r in dist.batch_isend_irecv(ops):
        r.wait()
    return bufs


def ring_allreduce_int8(x, group):
    """Ring reduce-scatter + all-gather with int8 hops over ``group``.

    x: (N, ...) f32, N the group's size; every rank holds a whole tensor
    and the result is the mean.  The reference's hop order and chunk
    indices: reduce-scatter hop k sends chunk (me - k) % n and adds the
    received one into chunk (me - k - 1) % n; all-gather hop k sends
    chunk (me - k + 1) % n and sets chunk (me - k) % n."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    acc = x.clone()
    for k in range(n - 1):
        q, s = _quantize_int8(acc[(me - k) % n])
        q, s = _shift((q, s), group, me, n)
        acc[(me - k - 1) % n] += _dequantize_int8(q, s)
    for k in range(n - 1):
        q, s = _quantize_int8(acc[(me - k + 1) % n])
        q, s = _shift((q, s), group, me, n)
        acc[(me - k) % n] = _dequantize_int8(q, s)
    return acc / n


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _like(whole, t):
    """``whole`` (equal on every rank) as ``t`` is: a DTensor of its
    placements, each rank keeping its shard, or a tensor."""
    if isinstance(t, DTensor):
        return distribute_tensor(whole, t.device_mesh, t.placements,
                                 src_data_rank=None)
    return whole


def _entries(tree, path=(), index=()) -> list:
    """(dict keys, list positions, leaf) of each leaf, in the tree's
    order."""
    if isinstance(tree, dict):
        return [e for k, v in tree.items()
                for e in _entries(v, path + (str(k),), index)]
    if isinstance(tree, list):
        return [e for i, v in enumerate(tree)
                for e in _entries(v, path, index + (i,))]
    return [(path, index, tree)]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_rebuild(v, it) for v in tree]
    return next(it)


def compressed_allreduce_tree(grads, ctx):
    """Mean-reduce a gradient tree across the DP axes with int8 ring hops.

    Every leaf (a tensor, or a DTensor taken whole) is flattened into one
    f32 vector, padded to a multiple of n (the DP ranks) and viewed as
    (n, -1); with one DP axis it rings over it, with two it rings over
    the inner one and takes the exact mean over the outer.  Each leaf
    comes back in its shape, dtype and placements."""
    if ctx is None or ctx.mesh is None or not ctx.batch_axes:
        return grads
    axes = ctx.batch_axes
    n = 1
    for a in axes:
        n *= ctx.size(a)
    # the reference's flatten order: its dict keys sorted, each of its
    # stacked leaves row-major (the port's layers in turn)
    entries = _entries(grads)
    order = sorted(range(len(entries)),
                   key=lambda i: (entries[i][0], entries[i][1]))
    leaves = [entries[i][2] for i in order]
    whole = [_whole(g) for g in leaves]
    sizes = [w.numel() for w in whole]
    flat = torch.cat([w.reshape(-1).float() for w in whole])
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % n))
    flat = flat.reshape(n, -1)
    out = ring_allreduce_int8(flat, ctx.group(axes[-1]))
    if len(axes) > 1:
        dist.all_reduce(out, group=ctx.group(axes[0]))
        out = out / ctx.size(axes[0])
    out = out.reshape(-1)
    outs, off = [None] * len(order), 0
    for i, g, w, sz in zip(order, leaves, whole, sizes):
        outs[i] = _like(out[off:off + sz].reshape(w.shape).to(w.dtype), g)
        off += sz
    return _rebuild(grads, iter(outs))


def hierarchical_psum_tree(grads, ctx):
    """Exact mean over the DP axes, innermost first, of each leaf (a
    DTensor's local shard, which its DP ranks hold alike)."""
    if ctx is None or ctx.mesh is None or not ctx.batch_axes:
        return grads

    def mean(g):
        local = g.to_local() if isinstance(g, DTensor) else g
        local = local.clone()
        for a in reversed(ctx.batch_axes):
            dist.all_reduce(local, group=ctx.group(a))
            local = local / ctx.size(a)
        if isinstance(g, DTensor):
            return DTensor.from_local(local, g.device_mesh, g.placements,
                                      run_check=False)
        return local

    return _rebuild(grads, iter([mean(e[2]) for e in _entries(grads)]))


def broadcast_object(value):
    """Rank 0's ``value`` on every rank of the world; ``value`` itself
    where there is no process group or it has one rank."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        box = [value]
        dist.broadcast_object_list(box, src=0)
        value = box[0]
    return value
