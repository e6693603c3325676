"""Measurement scripts for the port (they need a GPU)."""
