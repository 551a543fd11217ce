"""Blockwise (flash) attention: the CUDA kernel's wrapper and plain twin
(``flash_attention.py``) and the oracle (``ref.py``)."""
