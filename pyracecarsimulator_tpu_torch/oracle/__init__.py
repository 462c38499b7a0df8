"""Frozen NumPy parity oracles (copies of the JAX package's)."""

from . import dynamics, raycast
