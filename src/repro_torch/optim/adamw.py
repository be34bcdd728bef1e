"""AdamW, as ``repro.optim.adamw``: decoupled weight decay, f32 moments
over bf16 or f32 parameters, global-norm clipping, and a linear-warmup /
cosine schedule, with the reference's fields, defaults and arithmetic.

Parameters, gradients and moments are the port's trees (nested dicts and
lists of tensors).  ``update`` writes the new moments into the state it
was given, IN PLACE, and returns it, where the reference's ``jax.jit``
donates the old state's buffers; the step counter is a new tensor.  The
schedule, the bias corrections and the clip scale are f32 tensors on the
parameters' device, so an update reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.models.transformer import params_from_jax


def tree_leaves(tree) -> list:
    """The tensors of a nested dict / list, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


class AdamWState(NamedTuple):
    step: torch.Tensor         # () int32, updates taken so far
    m: dict
    v: dict


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1

    def schedule(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (a tensor), in f32."""
        step = step.float()
        warm = torch.clamp((step + 1) / max(1, self.warmup_steps), max=1.0)
        prog = torch.clamp((step - self.warmup_steps)
                           / max(1, self.total_steps - self.warmup_steps),
                           0, 1)
        cos = self.min_lr_frac + (1 - self.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return self.lr * warm * cos

    def init(self, params) -> AdamWState:
        """Zeroed f32 moments in the parameters' structure (DTensors of
        their placements on a mesh, meta tensors for meta parameters),
        step 0."""
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32,
                             device=tree_leaves(params)[0].device),
            m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params),
            v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, decay=None):
        """-> (updates in each parameter's dtype, the new state, {"gnorm",
        "lr"}).  ``decay``: a tree of bools in the parameters' structure,
        True where a leaf takes weight decay; None decays the leaves with
        ``p.ndim >= 2``, the reference's rule on its own (stacked) tree.
        A model's mask for its unstacked layers is
        ``models.transformer.decay_mask``."""
        if decay is None:
            decay = tree_map(lambda p: p.dim() >= 2, params)
        g_leaves = tree_leaves(grads)
        gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                               for g in g_leaves))
        scale = (torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
                 if self.clip_norm else 1.0)
        step = state.step + 1
        lr = self.schedule(step)
        bc1 = 1 - self.b1 ** step.float()
        bc2 = 1 - self.b2 ** step.float()

        def upd(p, g, m, v, d):
            g32 = g.float() * scale
            m.mul_(self.b1).add_((1 - self.b1) * g32)
            v.mul_(self.b2).add_((1 - self.b2) * g32 * g32)
            u = (m / bc1).div_(torch.sqrt(v / bc2).add_(self.eps))
            if d:
                u.add_(self.weight_decay * p.float())
            return (-lr * u).to(p.dtype)

        updates = tree_map(upd, params, grads, state.m, state.v, decay)
        return updates, AdamWState(step=step, m=state.m, v=state.v), \
            {"gnorm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates(params, updates):
    """Adds each update to its parameter IN PLACE, in the parameter's
    dtype; returns ``params``."""
    tree_map(lambda p, u: p.add_(u), params, updates)
    return params


def opt_state_from_jax(np_state, cfg, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves; ``m`` and ``v`` in its
    stacked parameter layout) -> the port's, through the unstacking of
    ``models.transformer.params_from_jax``."""
    return AdamWState(
        step=torch.tensor(int(np.asarray(np_state.step)), dtype=torch.int32,
                          device=device),
        m=params_from_jax(np_state.m, cfg, device),
        v=params_from_jax(np_state.v, cfg, device))
