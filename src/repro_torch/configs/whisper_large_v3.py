"""whisper-large-v3 [arXiv:2212.04356; unverified] — enc-dec, 32L enc + 32L
dec, d1280 20H, d_ff 5120, vocab 51866. Conv frontend is a STUB: input_specs
provides precomputed frame embeddings (B, 1500, 1280)."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="whisper-large-v3", family="encdec", n_layers=32, enc_layers=32,
    d_model=1280, n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866,
    norm="ln", act="gelu", pos="sinusoidal", enc_seq=1500)

SMOKE = ModelConfig(
    name="whisper-smoke", family="encdec", n_layers=2, enc_layers=2,
    d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
    norm="ln", act="gelu", pos="sinusoidal", enc_seq=30)
