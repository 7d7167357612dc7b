"""Serving: scheduler, KV cache and the slot engine (port of repro.serving)."""
