"""Family-dispatching model API, as ``repro.models.api``.

Every architecture exposes the same entry points:
    init(gen=None) -> params         (gen: a torch.Generator; None draws
                                      from seed 0 on the card)
    loss(params, batch, ctx=None) -> scalar    (the forward value)
    forward(params, batch, ctx=None) -> logits (B, T, V)
    prefill(params, batch, ctx=None, s_max=None) -> (logits (B, V), cache
                                      or state)
    decode_step(params, cache, token, pos, ctx=None) -> (logits (B, V),
                                      cache)
    make_cache(B, S, device="cuda", ctx=None) -> zeroed cache or state
    param_shape() -> the parameters as meta tensors (no memory)
The recurrent families (ssm: xLSTM, hybrid: RecurrentGemma) carry a
decode state of a fixed size: their ``prefill`` ignores ``s_max`` and
their ``make_cache`` ``S``, as the reference's do.  Inputs (numpy arrays
or tensors) go to the parameters' device.  ``ctx`` is a ``MeshCtx``: on a
mesh the parameters are DTensors (``parallel.distribute_tree`` of
``parallel.param_spec_tree``), each entry point runs in
``layers.mesh_scope`` and the cache or state is a tree of DTensors.  The
rest of the reference's dry-run contract (``input_specs``,
``cache_shape``) is ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial, wraps
from typing import Callable

import torch

from .common import ModelConfig
from .layers import mesh_scope
from . import rglru, transformer, xlstm


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is meta: an ``init`` drawn from it
    makes meta tensors, the shapes and dtypes with no memory."""

    @property
    def device(self):
        return torch.device("meta")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable          # (B, S) -> concrete zeroed cache

    def param_shape(self) -> dict:
        """``init``'s tree of meta tensors: each parameter's shape and
        dtype, with no memory and no random draw."""
        return self.init(_MetaGenerator())


def _init(init_fn: Callable, cfg: ModelConfig,
          gen: torch.Generator | None = None) -> dict:
    if gen is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
    return init_fn(cfg, gen)


def _scoped(fn: Callable) -> Callable:
    """``fn(*args, ctx=ctx)`` inside ``mesh_scope(ctx)``, with ``fn``'s
    signature."""
    @wraps(fn)
    def run(*args, ctx=None, **kw):
        with mesh_scope(ctx):
            return fn(*args, ctx=ctx, **kw)
    return run


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "ssm":
        fam = dict(
            init=partial(_init, xlstm.init_xlstm, cfg),
            loss=lambda p, b, ctx=None: xlstm.xlstm_loss(p, b, cfg, ctx),
            forward=lambda p, b, ctx=None:
                xlstm.xlstm_forward(p, b, cfg, ctx),
            prefill=lambda p, b, ctx=None, s_max=None:
                xlstm.xlstm_prefill(p, b, cfg, ctx),
            decode_step=lambda p, c, t, pos, ctx=None:
                xlstm.xlstm_decode_step(p, c, t, pos, cfg, ctx),
            make_cache=lambda B, S, device="cuda", ctx=None:
                xlstm.xlstm_states(cfg, B, device=device, ctx=ctx))
    elif cfg.family == "hybrid":
        fam = dict(
            init=partial(_init, rglru.init_rg, cfg),
            loss=lambda p, b, ctx=None: rglru.rg_loss(p, b, cfg, ctx),
            forward=lambda p, b, ctx=None: rglru.rg_forward(p, b, cfg, ctx),
            prefill=lambda p, b, ctx=None, s_max=None:
                rglru.rg_prefill(p, b, cfg, ctx),
            decode_step=lambda p, c, t, pos, ctx=None:
                rglru.rg_decode_step(p, c, t, pos, cfg, ctx),
            make_cache=lambda B, S, device="cuda", ctx=None:
                rglru.rg_states(cfg, B, device=device, ctx=ctx))
    else:
        fam = dict(
            init=partial(_init, transformer.init_lm, cfg),
            loss=lambda p, b, ctx=None: transformer.lm_loss(p, b, cfg, ctx),
            forward=lambda p, b, ctx=None:
                transformer.lm_forward(p, b, cfg, ctx),
            prefill=lambda p, b, ctx=None, s_max=None:
                transformer.lm_prefill(p, b, cfg, s_max=s_max, ctx=ctx),
            decode_step=lambda p, c, t, pos, ctx=None:
                transformer.lm_decode_step(p, c, t, pos, cfg, ctx),
            make_cache=lambda B, S, device="cuda", ctx=None:
                transformer.make_cache(cfg, B, S, device=device, ctx=ctx))
    return Model(cfg=cfg, init=fam["init"],
                 **{k: _scoped(fam[k]) for k in (
                     "loss", "forward", "prefill", "decode_step",
                     "make_cache")})
