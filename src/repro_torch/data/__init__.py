"""Synthetic data generators (port of repro.data, numpy only)."""
