"""BEANNA binary primitives (port of repro.core)."""
