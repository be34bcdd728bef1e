"""PyTorch + CUDA port of the paged-KV serving path of ``repro``.

The package mirrors the JAX package's layout (``kernels``, ``core``,
``volume``, ``models``, ``configs``, ``serve``, ``launch``) so every module
has a counterpart of the same name.  It imports torch, numpy and the
standard library only.  Entry points run on the card (``device="cuda"``)
unless the caller passes another device; the CPU runs each kernel's plain
PyTorch version.
"""
