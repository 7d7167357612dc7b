"""PyTorch + CUDA port of the BEANNA system for NVIDIA Hopper (H100).

Mirrors the JAX package ``repro`` module for module; ``repro`` stays the
reference the tests hold this package against. This package imports torch
and never jax, and nothing from ``repro``.
"""
