"""Sharding (port of ``repro/sharding``): the ambient mesh registry
(``context``) and the pool's shard count over a mesh (``rules``)."""
