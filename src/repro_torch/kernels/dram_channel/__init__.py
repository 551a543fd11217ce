"""The FR-FCFS DRAM channel model: the CUDA kernel's wrapper
(``dram_channel.py``) and its plain twin (``ref.py``, a host loop over
Python ints)."""
