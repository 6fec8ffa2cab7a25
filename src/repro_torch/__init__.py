"""PyTorch/CUDA port of the GALE relation engine (the reference package is
``repro``, in JAX).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
