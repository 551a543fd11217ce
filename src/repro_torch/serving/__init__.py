"""Request scheduling (port of ``repro/serving``)."""
