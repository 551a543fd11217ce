"""Kernels of the port: each hand-written CUDA kernel lives in ``csrc/``
with its wrapper and plain PyTorch twin here; ``build`` compiles them."""
