"""Batched PLA engine, protocols, metrics and evaluation (port of repro.core)."""
