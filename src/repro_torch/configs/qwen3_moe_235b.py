"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-30B-A3B family; hf] — 94L d4096 64H
(GQA kv=4) per-expert d_ff=1536, vocab 151936, MoE 128e top-8."""
from repro_torch.models.common import ModelConfig, MoECfg

FULL = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
    n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936,
    moe=MoECfg(n_experts=128, top_k=8, d_expert=1536))

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab=256,
    moe=MoECfg(n_experts=8, top_k=2, d_expert=96))
