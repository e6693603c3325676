"""Merged-checkpoint read/write and weights carried from the JAX package."""
