"""internlm2-1.8b [arXiv:2403.17297; hf] — dense 24L d2048 16H (GQA kv=8)
d_ff 8192, vocab 92544."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b", family="dense", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, d_ff=8192, vocab=92544)

SMOKE = ModelConfig(
    name="internlm2-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
