"""Architecture registry: ``get_config(arch_id, smoke=False)`` and the
reference's ten architectures: the four dense archs (which ``ServeEngine``
serves, the CLI's ``--arch`` values) and the MoE, encoder-decoder, VLM,
xLSTM and RecurrentGemma archs (through ``models.api.build_model``)."""
from __future__ import annotations

from importlib import import_module

from repro_torch.models.common import ModelConfig

_MODULES = {
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_16b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "qwen2.5-3b": "repro_torch.configs.qwen25_3b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1p8b",
    "deepseek-coder-33b": "repro_torch.configs.deepseek_coder_33b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama32_vision_11b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1p3b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, smoke: bool = False, **overrides) -> ModelConfig:
    mod = import_module(_MODULES[arch])
    cfg = mod.SMOKE if smoke else mod.FULL
    return cfg.with_(**overrides) if overrides else cfg
