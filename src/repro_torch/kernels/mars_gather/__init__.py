"""MARS-sorted embedding gather (plain tensor code; the Pallas kernel
K2 is not ported yet)."""
