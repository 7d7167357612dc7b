"""BNN-specific optimizer transform: clip latent weights to [-1, 1] after
each step (Courbariaux et al.; paper section 2A — keeps latents from
growing without changing the binarized weights, which would freeze their
gradients). Port of repro/optim/bnn.py, its MoE branch included."""

from __future__ import annotations

import torch

from repro_torch.tree import map_binary_denses, map_binary_moe


def _clip(t: torch.Tensor) -> torch.Tensor:
    return torch.clamp(t, -1.0, 1.0)


def _clip_moe(p: dict) -> dict:
    """A binary MoE layer with its expert stacks clipped.
    repro/optim/bnn.py:24-28 means the same but asks for a 3-D f32 leaf,
    which its stacked (L, E, K, N) segment leaves never are (ROADMAP C);
    the float MoE layers' stacks and the shared experts are not latents and
    stay as they are."""
    return {k: _clip(v) if k in ("w_gate", "w_up", "w_down") else v for k, v in p.items()}


def clip_latent_weights(params):
    """A copy of ``params`` (nested dicts and lists of tensors) with every
    ``w_latent`` and every binary MoE layer's expert stacks clipped to
    [-1, 1]; other leaves are shared, not copied."""
    out = map_binary_denses(lambda p: {**p, "w_latent": _clip(p["w_latent"])}, params)
    return map_binary_moe(_clip_moe, out)
