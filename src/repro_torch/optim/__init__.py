"""Optimizer transforms (port of repro.optim)."""

from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
)
from repro_torch.optim.bnn import clip_latent_weights  # noqa: F401
