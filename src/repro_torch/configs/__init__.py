"""Architecture registry: ``get_config(arch_id, smoke=False)`` and the
architectures the port serves so far (``--arch`` values)."""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen2.5-3b": "repro_torch.configs.qwen25_3b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    mod = import_module(_MODULES[arch])
    cfg = mod.SMOKE if smoke else mod.FULL
    return cfg.with_(**overrides) if overrides else cfg
