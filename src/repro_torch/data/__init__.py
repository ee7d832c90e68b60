"""Synthetic dataset surrogates (port of repro.data)."""
