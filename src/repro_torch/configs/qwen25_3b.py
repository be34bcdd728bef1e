"""qwen2.5-3b [hf:Qwen/Qwen2.5-0.5B family; hf] — dense 36L d2048 16H
(GQA kv=2) d_ff 11008, vocab 151936, QKV bias."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
    n_heads=16, n_kv_heads=2, d_ff=11008, vocab=151936, qkv_bias=True)

SMOKE = ModelConfig(
    name="qwen25-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, qkv_bias=True)
