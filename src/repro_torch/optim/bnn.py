"""BNN-specific optimizer transform: clip latent weights to [-1, 1] after
each step (Courbariaux et al.; paper section 2A — keeps latents from
growing without changing the binarized weights, which would freeze their
gradients). Port of repro/optim/bnn.py; its MoE branch comes with the other
model families (ROADMAP A8)."""

from __future__ import annotations

import torch

from repro_torch.tree import map_binary_denses


def clip_latent_weights(params):
    """A copy of ``params`` (nested dicts and lists of tensors) with every
    ``w_latent`` clipped to [-1, 1]; other leaves are shared, not copied."""
    return map_binary_denses(
        lambda p: {**p, "w_latent": torch.clamp(p["w_latent"], -1.0, 1.0)}, params)
