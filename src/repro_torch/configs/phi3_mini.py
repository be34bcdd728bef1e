"""phi3-mini-3.8b [arXiv:2404.14219; unverified] — dense 32L d3072 32H MHA,
d_ff 8192, vocab 32064, RoPE SwiGLU."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32064)

SMOKE = ModelConfig(
    name="phi3-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
