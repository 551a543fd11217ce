"""Host-side MARS reorder (port of ``repro/core``)."""
