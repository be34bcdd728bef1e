"""Train-step factory, as ``repro.train.step``: the model's loss and its
gradient, optional microbatch gradient accumulation, the optional
int8-compressed data-parallel gradient reduction on a mesh, and the AdamW
update.

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

updates the parameters and the optimizer's moments IN PLACE (under
``torch.no_grad()``) and returns them, where the reference's ``jax.jit``
donates their buffers.  Each leaf's ``.grad`` is set to None after the
update, so nothing carries over to the next step.  On a mesh (``ctx``)
the parameters and moments are DTensors, the step runs in
``models.layers.mesh_scope``, each gradient is reduced exactly to its
parameter's placements (an all-reduce over the DP axes), and the batch is
given whole on every rank (the model shards it).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.api import Model
from repro_torch.models.layers import mesh_scope, on_mesh
from repro_torch.models.transformer import decay_mask
from repro_torch.optim import AdamW, apply_updates, tree_leaves, tree_map
from repro_torch.parallel.collectives import compressed_allreduce_tree


def _micro(x, accum: int, i: int):
    """Microbatch i of ``accum`` along the leading dim: rows [i * b /
    accum, (i + 1) * b / accum), the reference's ``reshape(accum, b //
    accum, ...)[i]``."""
    b = x.shape[0]
    return x.reshape(accum, b // accum, *x.shape[1:])[i]


def _exact(p, g):
    """A DTensor gradient reduced to its parameter's placements (a partial
    sum over the DP axes all-reduced); a tensor as it is."""
    if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: Model, opt: AdamW, ctx=None, accum: int = 1,
                    grad_compression: str = "none"):
    """``grad_compression="int8"`` runs ``compressed_allreduce_tree`` on
    the gradients after their exact reduction, where ``ctx`` has a mesh
    with batch axes, as the reference does (it rings over copies that are
    already equal: ROADMAP Queue 3); elsewhere it does nothing."""
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: none or "
                         f"int8")
    compress = grad_compression == "int8" and on_mesh(ctx) \
        and bool(ctx.batch_axes)
    on = {"ctx": ctx} if ctx is not None else {}

    def grads_of(params, batch):
        """-> (loss, gradients in each parameter's dtype), the gradients
        left in each leaf's ``.grad``."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if accum <= 1:
            loss = model.loss(params, batch, **on)
            loss.backward()
            loss = loss.detach()
        else:
            # The reference takes each microbatch's gradient of its loss
            # and divides it by accum; the port backpropagates loss / accum,
            # which scales every gradient on the way down.  Both sum into a
            # zero in the parameter's dtype, microbatch by microbatch.  For
            # an accum that is a power of two the two round alike; for
            # others they may differ in the last bit of each product.
            loss = 0.0
            for i in range(accum):
                mb = {k: _micro(v, accum, i) for k, v in batch.items()}
                l_i = model.loss(params, mb, **on)
                (l_i / accum).backward()
                loss = loss + l_i.detach() / accum
        if isinstance(loss, DTensor):
            loss = loss.full_tensor()
        grads = tree_map(lambda p: _exact(p, p.grad) if p.grad is not None
                         else torch.zeros_like(p), params)
        return loss, grads

    def train_step(params, opt_state, batch):
        with mesh_scope(ctx):
            loss, grads = grads_of(params, batch)
            if compress:
                grads = compressed_allreduce_tree(grads, ctx)
            updates, opt_state, om = opt.update(
                grads, opt_state, params,
                decay=decay_mask(params, model.cfg))
            for p in tree_leaves(params):
                p.grad = None
            apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **om}

    return train_step
