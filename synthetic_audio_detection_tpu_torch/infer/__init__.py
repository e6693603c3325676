"""Serving pipeline: windows to logits to verdicts to JSON."""
