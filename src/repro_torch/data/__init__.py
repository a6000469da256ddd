"""Synthetic, restart-safe training data (copy of ``repro/data``)."""
