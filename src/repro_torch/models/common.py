"""Model configuration, as ``repro.models.common`` with torch dtypes.

The fields the dense decoder family reads, under the reference's names;
the other families' fields and the knobs that steer JAX's compiler come
with the slices that need them.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int              # per-expert FFN hidden size
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                # dense | moe | encdec | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0          # 0 -> derived d_model // n_heads
    moe: MoECfg | None = None
    qkv_bias: bool = False
    norm: str = "rms"          # rms | ln
    act: str = "swiglu"        # swiglu | gelu
    rope_theta: float = 1e6
    pos: str = "rope"          # rope | sinusoidal | none
    tie_embeddings: bool = False
    attn_window: int = 0       # 0 = full causal; >0 = local sliding window
    dtype: Any = torch.bfloat16

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)
