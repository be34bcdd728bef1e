"""moonshot-v1-16b-a3b (kimi/moonlight) [hf:moonshotai/Moonlight-16B-A3B; hf]
— 48L d2048 16H (GQA kv=16 ≡ MHA) per-expert d_ff=1408, MoE 64e top-6."""
from repro_torch.models.common import ModelConfig, MoECfg

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1408, vocab=163840,
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408))

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=96, vocab=256,
    moe=MoECfg(n_experts=4, top_k=2, d_expert=96))
