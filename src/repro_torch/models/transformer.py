"""Decoder LM parameters for the dense family: random init from a
``torch.Generator`` (``repro.models.transformer.init_lm``'s distributions)
and the converter from a JAX parameter pytree.

Parameters are a plain dict: ``embed`` (V, D), ``head`` (D, V) unless tied,
``final_norm``, and ``blocks``, a list with one dict per layer
(``ln1``, ``attn``, ``ln2``, ``mlp``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .common import ModelConfig
from .layers import attn_init, init_norm, mlp_init


def init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dev = cfg.d_model, gen.device
    return {"ln1": init_norm(d, cfg.norm, dev),
            "attn": attn_init(gen, d, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              cfg.qkv_bias, cfg.dtype),
            "ln2": init_norm(d, cfg.norm, dev),
            "mlp": mlp_init(gen, d, cfg.d_ff, cfg.act, cfg.dtype)}


def init_lm(cfg: ModelConfig, gen: torch.Generator) -> dict:
    """Random dense-LM parameters on ``gen.device``, drawn in a fixed order
    (embed, head, then each layer) so one seed gives one model."""
    assert cfg.family == "dense", "the port initialises dense LMs only"
    d, V = cfg.d_model, cfg.vocab
    dev = gen.device
    params = {"embed": (torch.randn((V, d), generator=gen, device=dev)
                        / math.sqrt(d)).to(cfg.dtype),
              "final_norm": init_norm(d, cfg.norm, dev)}
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((d, V), generator=gen, device=dev)
                          / math.sqrt(d)).to(cfg.dtype)
    params["blocks"] = [init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return params


def _leaf(a, device) -> torch.Tensor:
    """One numpy leaf -> tensor.  bf16 (which numpy holds as ml_dtypes'
    type) goes through f32, which holds every bf16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _tree(x, device):
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    return _leaf(x, device)


def params_from_jax(np_tree: dict, cfg: ModelConfig, device="cuda") -> dict:
    """The JAX param pytree of a dense LM (leaves as numpy arrays,
    ``blocks`` stacked on the layer axis) -> the port's parameters."""
    out = {k: _tree(v, device) for k, v in np_tree.items() if k != "blocks"}
    stacked = np_tree["blocks"]

    def layer(x, i):
        if isinstance(x, dict):
            return {k: layer(v, i) for k, v in x.items()}
        return _leaf(np.asarray(x)[i], device)

    out["blocks"] = [layer(stacked, i) for i in range(cfg.n_layers)]
    return out
