"""Model definitions (port of ``repro/models``, dense family)."""
