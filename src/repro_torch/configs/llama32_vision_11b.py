"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision; unverified] —
40L d4096 32H (GQA kv=8) d_ff 14336, vocab 128256; gated cross-attn image
layers every 5th layer; vision tower is a STUB: input_specs provides patch
embeddings (B, 1600, 4096)."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, cross_every=5,
    n_img_tokens=1600)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=128, vocab=256, cross_every=2,
    n_img_tokens=16)
