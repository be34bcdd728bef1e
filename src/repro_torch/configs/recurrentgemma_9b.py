"""recurrentgemma-9b [arXiv:2402.19427; unverified] — 38L, (RG-LRU, RG-LRU,
local attn) 2:1 pattern, d4096 16H (MQA kv=1), d_ff 12288, vocab 256000,
window 2048. lru_width = d_model (documented deviation)."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, d_ff=12288, vocab=256000, attn_window=2048,
    block_pattern=("rec", "rec", "attn"))

SMOKE = ModelConfig(
    name="rg-smoke", family="hybrid", n_layers=5, d_model=64,
    n_heads=4, n_kv_heads=1, d_ff=128, vocab=256, attn_window=32,
    block_pattern=("rec", "rec", "attn"))
