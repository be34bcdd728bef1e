"""Model configuration, as ``repro.models.common`` with torch dtypes, the
dry run's production shapes (``ShapeCfg``, ``SHAPES``,
``shape_applicable``), and the activation checkpointing that the
``remat`` field selects.

The reference's fields under its names and defaults, except the knobs
that steer JAX's compiler (``attn_impl``, ``scan_layers``) and the chunk
of its XLA attention (``attn_chunk``), since the port runs eagerly and
attends through the flash kernel.  ``MeshCtx`` is the reference's, over a
``torch.distributed`` ``DeviceMesh``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)


@dataclass(frozen=True)
class MeshCtx:
    """How model code should see the device mesh (None = one device).

    mesh: a ``DeviceMesh`` with named dims.  batch_axes: mesh axes the
    batch dim is sharded over (may be empty, e.g. batch=1 long-context
    decode).  model_axis: the TP/EP axis name."""
    mesh: Any = None
    batch_axes: tuple = ()
    model_axis: str | None = None

    def size(self, axis: str | None) -> int:
        """The mesh's size along ``axis`` (1 for None or an axis it lacks)."""
        if self.mesh is None or axis not in (self.mesh.mesh_dim_names or ()):
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    def rank(self, axis: str | None) -> int:
        """This rank's coordinate along ``axis`` (0 for None)."""
        if self.mesh is None or axis not in (self.mesh.mesh_dim_names or ()):
            return 0
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def batch_shards(self) -> tuple[int, int]:
        """(this rank's index, count) of the batch shards over
        ``batch_axes``, the first axis major."""
        i, n = 0, 1
        for a in self.batch_axes:
            i, n = i * self.size(a) + self.rank(a), n * self.size(a)
        return i, n


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
    # family extras ----------------------------------------------------------
    enc_layers: int = 0        # encdec: encoder depth
    enc_seq: int = 1500        # whisper frame count (stub frontend output)
    cross_every: int = 0       # vlm: a cross-attn layer every Nth layer
    n_img_tokens: int = 1600   # vlm stub patch-embedding count
    attn_window: int = 0       # 0 = full causal; >0 = local sliding window
    block_pattern: tuple[str, ...] = ()   # hybrid/ssm per-group layer kinds
    lru_width: int = 0         # rglru: recurrence width (0 -> d_model)
    # numerics ----------------------------------------------------------------
    dtype: Any = torch.bfloat16
    remat: str = "dots"        # none | dots | full
    logits_f32: bool = True

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        return self.family in ("ssm", "hybrid")

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    # --------------------------------------------------------- param counts
    def param_count(self) -> int:
        """Analytic parameter count, the reference's formula."""
        D, hd = self.d_model, self.hd
        qo = D * self.n_heads * hd * 2
        kv = D * self.n_kv_heads * hd * 2
        if self.family == "ssm":
            body = self.n_layers * (5 * D * D + 2 * D)   # mLSTM-ish
        elif self.family == "hybrid":
            R = self.lru_width or D
            rec = 2 * D * R + 2 * R * R + R * D + 4 * R
            mlp = 3 * D * self.d_ff
            n_attn = sum(1 for i in range(self.n_layers)
                         if self._layer_kind(i) == "attn")
            body = (self.n_layers - n_attn) * (rec + mlp) \
                + n_attn * (qo + kv + mlp)
        else:
            if self.moe:
                mlp = self.moe.n_experts * 3 * D * self.moe.d_expert \
                    + D * self.moe.n_experts
            else:
                mlp = (3 if self.act == "swiglu" else 2) * D * self.d_ff
            body = self.n_layers * (qo + kv + mlp)
            if self.family == "encdec":
                body += self.enc_layers * (qo + kv + 2 * D * self.d_ff)
                body += self.n_layers * (qo + kv)      # decoder cross-attn
            if self.family == "vlm" and self.cross_every:
                body += self.n_layers // self.cross_every * (qo + kv)
        embed = self.vocab * D * (1 if self.tie_embeddings else 2)
        return body + embed

    def active_param_count(self) -> int:
        """Active params per token (MoE top-k)."""
        if not self.moe:
            return self.param_count()
        D = self.d_model
        dense_mlp = self.moe.top_k * 3 * D * self.moe.d_expert \
            + D * self.moe.n_experts
        full_mlp = self.moe.n_experts * 3 * D * self.moe.d_expert \
            + D * self.moe.n_experts
        return self.param_count() - self.n_layers * (full_mlp - dense_mlp)

    def _layer_kind(self, i: int) -> str:
        if not self.block_pattern:
            return "attn"
        return self.block_pattern[i % len(self.block_pattern)]


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    kind: str        # train | prefill | decode
    seq: int
    batch: int


# the reference's production shapes (``repro.models.common.SHAPES``)
SHAPES: dict[str, ShapeCfg] = {
    "train_4k":    ShapeCfg("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeCfg("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeCfg("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeCfg("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeCfg) -> tuple[bool, str]:
    """Which (arch x shape) cells run, the reference's rule."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full-attention arch: 500k dense KV decode skipped per assignment"
    return True, ""


# the products that "dots" keeps: matrix products with no batch dimension
# (a (B, T, D) @ (D, F) projection reaches the dispatcher as ``aten.mm``)
_SAVED_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _dots_context():
    return create_selective_checkpoint_contexts(_SAVED_DOTS)


def remat(fn, mode: str):
    """``fn`` under the reference's ``_remat`` for the training forward:
    ``"none"`` keeps every activation; ``"full"`` keeps only ``fn``'s
    inputs and recomputes the rest in the backward; ``"dots"`` (the
    counterpart of ``dots_with_no_batch_dims_saveable``) also keeps the
    outputs of ``aten.mm`` and ``aten.addmm`` and recomputes everything
    else.  The flash kernel's op (``repro_torch::flash_attention``) is
    not among them, so under either it runs again in the backward.  With
    grad disabled ``fn`` runs as it is."""
    if mode not in ("none", "dots", "full"):
        raise ValueError(f"remat {mode!r}: none, dots or full")
    if mode == "none":
        return fn
    kw = {"context_fn": _dots_context} if mode == "dots" else {}

    def checkpointed(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False, **kw)
    return checkpointed
