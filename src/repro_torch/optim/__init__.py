"""Optimizer transforms (port of repro.optim)."""
