"""Layers and attention (port of repro.nn)."""
