"""Train-step factory, as ``repro.train.step`` without a mesh: the model's
loss and its gradient, optional microbatch gradient accumulation, and the
AdamW update.

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)

updates the parameters and the optimizer's moments IN PLACE (under
``torch.no_grad()``) and returns them, where the reference's ``jax.jit``
donates their buffers.  Each leaf's ``.grad`` is set to None after the
update, so nothing carries over to the next step.
"""
from __future__ import annotations

import torch

from repro_torch.models.api import Model
from repro_torch.models.transformer import decay_mask
from repro_torch.optim import AdamW, apply_updates, tree_leaves, tree_map


def _micro(x, accum: int, i: int):
    """Microbatch i of ``accum`` along the leading dim: rows [i * b /
    accum, (i + 1) * b / accum), the reference's ``reshape(accum, b //
    accum, ...)[i]``."""
    b = x.shape[0]
    return x.reshape(accum, b // accum, *x.shape[1:])[i]


def make_train_step(model: Model, opt: AdamW, accum: int = 1,
                    grad_compression: str = "none"):
    """``grad_compression="int8"`` compresses the data-parallel gradient
    reduction over a mesh; without one (the port has none yet, ROADMAP
    Queue 1 item 4) it does nothing, as the reference's does with no
    ``ctx``."""
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: none or "
                         f"int8")

    def grads_of(params, batch):
        """-> (loss, gradients in each parameter's dtype), the gradients
        left in each leaf's ``.grad``."""
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
            p.grad = None
        if accum <= 1:
            loss = model.loss(params, batch)
            loss.backward()
            loss = loss.detach()
        else:
            # The reference takes each microbatch's gradient of its loss
            # and divides it by accum; the port backpropagates loss / accum,
            # which scales every gradient on the way down.  Both sum into a
            # zero in the parameter's dtype, microbatch by microbatch.  For
            # an accum that is a power of two the two round alike; for
            # others they may differ in the last bit of each product.
            loss = torch.zeros((), device=leaves[0].device)
            for i in range(accum):
                mb = {k: _micro(v, accum, i) for k, v in batch.items()}
                l_i = model.loss(params, mb)
                (l_i / accum).backward()
                loss = loss + l_i.detach() / accum
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        return loss, grads

    def train_step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        updates, opt_state, om = opt.update(
            grads, opt_state, params, decay=decay_mask(params, model.cfg))
        for p in tree_leaves(params):
            p.grad = None
        apply_updates(params, updates)
        return params, opt_state, {"loss": loss, **om}

    return train_step
