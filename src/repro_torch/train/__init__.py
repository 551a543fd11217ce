"""Train step (port of ``repro/train``)."""
