"""xlstm-1.3b [arXiv:2405.04517; unverified] — 48 blocks, mLSTM:sLSTM = 7:1,
d2048 4H (head 512), d_ff=0 (self-contained blocks), vocab 50304."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab=50304, pos="none")

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", n_layers=8, d_model=64,
    n_heads=2, n_kv_heads=2, d_ff=0, vocab=256, pos="none")
