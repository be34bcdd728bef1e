"""Hand-written CUDA kernels (``csrc/``) for the serving path, with their
plain PyTorch versions: prefill (flash) attention, paged decode attention
and the fused transit codec.
See ops.py for the dispatching public API and ref.py for the twins of the
JAX oracles."""
from .ops import (flash_attention, gather_quantize, gather_quantize_crc,
                  paged_attention, scatter_dequantize, scatter_dequantize_crc)

__all__ = ["flash_attention", "paged_attention", "gather_quantize",
           "scatter_dequantize", "gather_quantize_crc",
           "scatter_dequantize_crc"]
