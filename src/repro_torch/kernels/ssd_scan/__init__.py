"""SSD (Mamba2) chunked scan: the CUDA kernel's wrapper and plain twin
(``ssd_scan.py``) and the sequential oracle (``ref.py``)."""
