"""Per-layer precision decisions (port of repro/core/policy.py).
PrecisionPolicy lives in configs/base.py (it is config); these helpers
apply it: BEANNA's per-layer mode signal, and the config's dtypes as torch
dtypes."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, PrecisionPolicy  # noqa: F401


def binary_block_mask(cfg: ModelConfig) -> list[bool]:
    """Per-block binary flag (paper rule: edge blocks stay float)."""
    return [cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers)]


def param_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)
