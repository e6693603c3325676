"""Host-side audio helpers that the JAX package keeps in JAX modules."""
