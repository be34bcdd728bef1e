"""Family-dispatching model API, as ``repro.models.api`` without a mesh.

Every architecture exposes the same entry points:
    init(gen=None) -> params         (gen: a torch.Generator; None draws
                                      from seed 0 on the card)
    loss(params, batch) -> scalar    (the forward value)
    forward(params, batch) -> logits (B, T, V)
    prefill(params, batch, s_max=None) -> (logits (B, V), cache or state)
    decode_step(params, cache, token, pos) -> (logits (B, V), cache)
    make_cache(B, S, device="cuda") -> zeroed cache or state
The recurrent families (ssm: xLSTM, hybrid: RecurrentGemma) carry a
decode state of a fixed size: their ``prefill`` ignores ``s_max`` and
their ``make_cache`` ``S``, as the reference's do.  Inputs (numpy arrays
or tensors) go to the parameters' device.  The reference's dry-run
contract (``input_specs``, ``cache_shape``, ``param_shape``) is ROADMAP
Queue 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from .common import ModelConfig
from . import rglru, transformer, xlstm


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable          # (B, S) -> concrete zeroed cache


def _init(init_fn: Callable, cfg: ModelConfig,
          gen: torch.Generator | None = None) -> dict:
    if gen is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
    return init_fn(cfg, gen)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            init=partial(_init, xlstm.init_xlstm, cfg),
            loss=lambda p, b: xlstm.xlstm_loss(p, b, cfg),
            forward=lambda p, b: xlstm.xlstm_forward(p, b, cfg),
            prefill=lambda p, b, s_max=None: xlstm.xlstm_prefill(p, b, cfg),
            decode_step=lambda p, c, t, pos:
                xlstm.xlstm_decode_step(p, c, t, pos, cfg),
            make_cache=lambda B, S, device="cuda":
                xlstm.xlstm_states(cfg, B, device=device),
        )
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            init=partial(_init, rglru.init_rg, cfg),
            loss=lambda p, b: rglru.rg_loss(p, b, cfg),
            forward=lambda p, b: rglru.rg_forward(p, b, cfg),
            prefill=lambda p, b, s_max=None: rglru.rg_prefill(p, b, cfg),
            decode_step=lambda p, c, t, pos:
                rglru.rg_decode_step(p, c, t, pos, cfg),
            make_cache=lambda B, S, device="cuda":
                rglru.rg_states(cfg, B, device=device),
        )
    return Model(
        cfg=cfg,
        init=partial(_init, transformer.init_lm, cfg),
        loss=lambda p, b: transformer.lm_loss(p, b, cfg),
        forward=lambda p, b: transformer.lm_forward(p, b, cfg),
        prefill=lambda p, b, s_max=None:
            transformer.lm_prefill(p, b, cfg, s_max=s_max),
        decode_step=lambda p, c, t, pos:
            transformer.lm_decode_step(p, c, t, pos, cfg),
        make_cache=lambda B, S, device="cuda":
            transformer.make_cache(cfg, B, S, device=device),
    )
