"""PyTorch/CUDA port of the RRTO reproduction (``repro``), for an NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports nothing
of it and nothing of JAX.
"""
