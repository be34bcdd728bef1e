"""Sharding rules, as ``repro.parallel.sharding``: the reference's
``PartitionSpec`` of every parameter, batch and cache leaf, found from
its path, as a tuple with one entry per tensor dim (a mesh-axis name, a
tuple of names, or None); and their DTensor placements.

TP: megatron-style column/row parallel on the flat projection axes. EP:
MoE expert tensors sharded on the expert axis over ``model``, with the
per-expert FFN axis over ``data`` where it divides (ZeRO-3 storage,
gathered per layer in ``models.layers.moe_apply``).  DP: the batch over
(``pod``, ``data``) when divisible.  ZeRO-1: optimizer moments also
sharded over ``data`` (``zero_spec``).

The port keeps the layers as lists where the reference stacks them on
leading axes.  A per-layer leaf's spec is the reference's spec of the
stacked leaf (the lists' lengths in front of its shape) with the stack
axes dropped: the rules read the stacked shape, so they are the
reference's text.  The caches keep the reference's stacked layout, so
their specs are the reference's as they are.

A mesh is a ``DeviceMesh`` with named dims, or a ``{name: size}`` dict.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

MODEL_AXIS = "model"
# keys whose -2 axis (contracting / vocab-in) is model-sharded (row-parallel)
_ROW_KEYS = {"wo", "wout", "w_out", "wd", "embed"}
# keys never sharded.  rz: the sLSTM per-head recurrence matrix is read
# every token inside the sequential scan
_REPL_KEYS = {"scale", "bias", "ln", "xgate", "router", "lam", "bif", "bf",
              "conv_b", "ri", "rf", "rz"}


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``, a dict, or None ({})."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def map_tree(fn, tree, *rest, path=(), stack=()):
    """``fn(path, stack, leaf, *rest_leaves)`` over a tree of dicts, lists
    and NamedTuples: ``path`` the dict keys (and NamedTuple fields) down to
    the leaf, ``stack`` the lengths of the lists above it.  The result has
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest), path=path + (k,),
                            stack=stack) for k, v in tree.items()}
    if isinstance(tree, list):
        n = len(tree)
        return [map_tree(fn, v, *(r[i] for r in rest), path=path,
                         stack=stack + (n,)) for i, v in enumerate(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tree(fn, getattr(tree, f),
                                     *(getattr(r, f) for r in rest),
                                     path=path + (f,), stack=stack)
                            for f in tree._fields))
    return fn(path, stack, tree, *rest)


def _drop(spec: tuple, stack: tuple) -> tuple:
    return tuple(spec[len(stack):])


def _param_rule(path: tuple, shape: tuple, mesh: dict) -> tuple:
    """The reference's rule for one (stacked) parameter leaf."""
    tp = mesh.get(MODEL_AXIS, 1)
    key = str(path[-1]) if path else ""
    pstr = "/".join(str(p) for p in path)
    nd = len(shape)
    none = (None,) * nd
    if key in _REPL_KEYS or nd == 0:
        return none
    if "moe" in pstr and key in ("wg", "wu", "wd") and nd >= 3:
        ax = nd - 3                      # expert axis of (.., E, D, F)
        if shape[ax] % tp != 0:
            return none
        parts = list(none)
        parts[ax] = MODEL_AXIS
        # ZeRO-3 expert storage: per-expert FFN axis over 'data'
        dp = mesh.get("data", 1)
        f_ax = nd - 1 if key in ("wg", "wu") else nd - 2
        if dp > 1 and shape[f_ax] % dp == 0:
            parts[f_ax] = "data"
        return tuple(parts)
    if key in _ROW_KEYS and nd >= 2:
        ax = nd - 2
        if shape[ax] % tp == 0:
            return none[:ax] + (MODEL_AXIS,) + none[ax + 1:]
        return none
    # default: column-parallel on the last axis
    if shape[-1] % tp == 0 and shape[-1] >= tp:
        return none[:-1] + (MODEL_AXIS,)
    return none


def param_spec_tree(param_shapes, mesh):
    """The spec of every parameter leaf (tensors, meta tensors or shapes):
    the reference's rule on the stacked shape, the stack axes dropped."""
    ms = mesh_shape(mesh)
    return map_tree(lambda path, stack, leaf: _drop(
        _param_rule(path, stack + _shape(leaf), ms), stack), param_shapes)


def batch_axes_for(mesh, batch: int) -> tuple:
    """Largest prefix of (pod, data) that divides the global batch."""
    ms = mesh_shape(mesh)
    chosen, size = [], 1
    for a in (a for a in ("pod", "data") if a in ms):
        if batch % (size * ms[a]) == 0:
            chosen.append(a)
            size *= ms[a]
    return tuple(chosen)


def make_ctx(mesh, batch: int):
    from repro_torch.models.common import MeshCtx
    if mesh is None:
        return MeshCtx()
    return MeshCtx(mesh=mesh, batch_axes=batch_axes_for(mesh, batch),
                   model_axis=MODEL_AXIS if MODEL_AXIS in mesh_shape(mesh)
                   else None)


def batch_spec_tree(batch_shapes, ctx):
    b = ctx.batch_axes if ctx.batch_axes else None
    return map_tree(lambda path, stack, leaf:
                    (b,) + (None,) * (len(_shape(leaf)) - 1), batch_shapes)


def _cache_rule(path: tuple, shape: tuple, b, tp: int) -> tuple:
    key = str(path[-1]) if path else ""
    nd = len(shape)
    none = [None] * nd
    if key in ("k", "v", "pos") and "cross" not in key:
        # (.., B, S, Hkv, hd) or (.., B, S): locate B as the axis before S
        s_ax = nd - 3 if key != "pos" else nd - 1
        none[s_ax - 1] = b
        if shape[s_ax] % tp == 0:
            none[s_ax] = MODEL_AXIS
        return tuple(none)
    if key in ("cross_k", "cross_v"):
        none[nd - 4] = b                 # (.., B, S_enc, Hkv, hd)
        return tuple(none)
    # ssm states.  mLSTM C (.., d, e) is contracted over e (h = C q):
    # shard the output axis d (-2)
    if key == "C" and nd >= 2:
        if shape[-2] % tp == 0 and shape[-2] >= tp:
            none[-2] = MODEL_AXIS
        return tuple(none)
    if key in ("n", "m", "c", "h", "tail"):
        if shape[-1] % tp == 0 and nd >= 2 and shape[-1] >= tp:
            none[-1] = MODEL_AXIS
        return tuple(none)
    return tuple(none)


def cache_spec_tree(cache_shapes, ctx, mesh=None):
    """KV caches: batch over DP axes; the S axis over 'model' when
    divisible (the sequence-sharded decode of
    ``models.layers.decode_update_and_attend``); SSM states: last axis
    over 'model' when divisible."""
    tp = mesh_shape(ctx.mesh if mesh is None else mesh).get(MODEL_AXIS, 1)
    b = ctx.batch_axes if ctx.batch_axes else None
    return map_tree(lambda path, stack, leaf:
                    _drop(_cache_rule(path, stack + _shape(leaf), b, tp),
                          stack), cache_shapes)


def zero_spec(spec: tuple, shape, mesh, axis: str = "data") -> tuple:
    """ZeRO-1: additionally shard optimizer moments over the DP axis, on
    the largest not-yet-sharded tensor axis that divides."""
    ms = mesh_shape(mesh)
    if axis not in ms:
        return spec
    dp = ms[axis]
    shape = _shape(shape)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if axis in parts:
        return spec          # already sharded over this axis (ZeRO-3 experts)
    best, best_ax = 0, -1
    for i, (s, cur) in enumerate(zip(shape, parts)):
        if cur is None and s % dp == 0 and s > best:
            best, best_ax = s, i
    if best_ax < 0:
        return spec
    parts[best_ax] = axis
    return tuple(parts)


def zero_spec_tree(param_shapes, mesh):
    """ZeRO-1 specs of the moments of ``param_shapes``' leaves: the
    reference's ``zero_spec`` of each stacked leaf's parameter spec, the
    stack axes dropped."""
    ms = mesh_shape(mesh)

    def rule(path, stack, leaf):
        shape = stack + _shape(leaf)
        return _drop(zero_spec(_param_rule(path, shape, ms), shape, ms),
                     stack)
    return map_tree(rule, param_shapes)


# ------------------------------------------------------------- placements
def placements(spec: tuple, mesh) -> tuple:
    """A spec -> one placement per mesh dim: ``Shard(d)`` where tensor dim
    d names that mesh axis (alone or in a tuple), else ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, s in enumerate(spec)
                if s == name or (isinstance(s, tuple) and name in s)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def distribute(t: torch.Tensor, spec: tuple, mesh) -> DTensor:
    """One tensor, whole and equal on every rank, as a DTensor of
    ``spec``."""
    return place(t, placements(spec, mesh), mesh)


def place(t: torch.Tensor, pl, mesh) -> DTensor:
    """One tensor, whole and equal on every rank, as a DTensor of the
    placements ``pl``: each rank keeps a copy of its own shard (``t``
    itself where ``pl`` is all ``Replicate()``), with no communication.
    On a mesh of one rank the DTensor wraps ``t`` itself, with no copy."""
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, pl, run_check=False)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def distribute_tree(tree, specs, mesh):
    """The counterpart of the reference's ``named`` and ``device_put``: a
    tree of whole tensors and its spec tree -> a tree of DTensors."""
    return map_tree(lambda path, stack, t, spec: distribute(t, spec, mesh),
                    tree, specs)


def full_tree(tree):
    """A tree of DTensors (or tensors) -> the whole tensors."""
    return map_tree(lambda path, stack, t: t.full_tensor()
                    if isinstance(t, DTensor) else t, tree)
