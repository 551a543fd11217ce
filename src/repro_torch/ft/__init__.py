"""Fault tolerance: checkpoints and the run supervisor (port of
``repro/ft``)."""
