"""Family-dispatching model API, as ``repro.models.api`` without a mesh.

Every transformer architecture exposes the same entry points:
    init(gen=None) -> params         (gen: a torch.Generator; None draws
                                      from seed 0 on the card)
    loss(params, batch) -> scalar    (the forward value)
    forward(params, batch) -> logits (B, T, V)
    prefill(params, batch, s_max=None) -> (logits (B, V), cache)
    decode_step(params, cache, token, pos) -> (logits (B, V), cache)
    make_cache(B, S, device="cuda") -> zeroed cache
Inputs (numpy arrays or tensors) go to the parameters' device.  The
reference's dry-run contract (``input_specs``, ``cache_shape``,
``param_shape``) is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import torch

from .common import ModelConfig
from . import transformer


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    make_cache: Callable          # (B, S) -> concrete zeroed cache


def _init(cfg: ModelConfig, gen: torch.Generator | None = None) -> dict:
    if gen is None:
        gen = torch.Generator(device="cuda").manual_seed(0)
    return transformer.init_lm(cfg, gen)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"{cfg.name}: {transformer.RECURRENT}")
    return Model(
        cfg=cfg,
        init=partial(_init, cfg),
        loss=lambda p, b: transformer.lm_loss(p, b, cfg),
        forward=lambda p, b: transformer.lm_forward(p, b, cfg),
        prefill=lambda p, b, s_max=None:
            transformer.lm_prefill(p, b, cfg, s_max=s_max),
        decode_step=lambda p, c, t, pos:
            transformer.lm_decode_step(p, c, t, pos, cfg),
        make_cache=lambda B, S, device="cuda":
            transformer.make_cache(cfg, B, S, device=device),
    )
