"""BinaryDense: the paper's binary layer (port of repro/core/binary_dense.py).

The layer keeps the float latent weight ``w_latent`` (K, N), as repro
does, and beside it the packed sign words ``w_packed`` (N, K/32) that the
int8 kernel reads, made once when the layer is created or loaded. A
per-output ``scale`` (init 1/sqrt(K)) maps the integer dot back to unit
variance.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.binarize import pack_bits
from repro_torch.kernels import ops


def with_packed(p: dict) -> dict:
    """Add (or refresh) the packed copy of the latent weight."""
    return {**p, "w_packed": pack_bits(p["w_latent"].T)}


def binary_dense_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
                      device, scale: bool = True, dtype=torch.float32) -> dict:
    """w_latent ~ U(-1, 1), as repro draws it (from torch's generator, so
    not the same numbers)."""
    w = torch.rand((in_dim, out_dim), generator=generator, device=device) * 2 - 1
    p = {"w_latent": w.to(dtype)}
    if scale:
        p["scale"] = torch.full((out_dim,), 1.0 / math.sqrt(in_dim),
                                dtype=torch.float32, device=device)
    return with_packed(p)


def binary_dense_apply(p: dict, x: torch.Tensor, *, mode: str = "int8") -> torch.Tensor:
    """int dot in x's dtype, times the f32 scale, back to x's dtype — the
    order of repro/core/binary_dense.py:37-39."""
    y = ops.binary_dense(x, p["w_packed"], mode=mode)
    if "scale" in p:
        y = y * p["scale"]
    return y.to(x.dtype)
