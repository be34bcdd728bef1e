"""deepseek-coder-33b [arXiv:2401.14196; hf] — dense llama-arch 62L d7168
56H (GQA kv=8) d_ff 19200, vocab 32256."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-coder-33b", family="dense", n_layers=62, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=19200, vocab=32256)

SMOKE = ModelConfig(
    name="deepseek-smoke", family="dense", n_layers=2, d_model=56,
    n_heads=7, n_kv_heads=1, d_ff=128, vocab=256)
