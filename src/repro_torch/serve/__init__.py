"""Continuous-batching serve engine (port of ``repro/serve``)."""
