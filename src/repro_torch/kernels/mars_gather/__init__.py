"""MARS-sorted embedding gather: the row-gather kernel's wrapper and
plain twin (``mars_gather.py``), the op (``ops.py``) and its oracle
(``ref.py``)."""
