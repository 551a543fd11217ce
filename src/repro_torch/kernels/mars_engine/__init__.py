"""The MARS cycle engine: the CUDA kernel's wrapper (``mars_engine.py``)
and its plain twin (``ref.py``, a host loop over Python ints)."""
