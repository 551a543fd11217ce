"""MARS-sorted MoE dispatch: the grouped-GEMM kernel's wrapper and plain
twin (``moe_dispatch.py``), the op (``ops.py``) and its oracles
(``ref.py``)."""
