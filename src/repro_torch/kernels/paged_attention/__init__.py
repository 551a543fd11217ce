"""Paged-KV decode attention: the Hopper kernel wrapper, its plain twin,
the oracle and the pool -> kernel operand bridge."""
