"""BinaryDense: the paper's binary layer (port of repro/core/binary_dense.py).

Training keeps a float latent weight ``w_latent`` (K, N), clipped to
[-1, 1] by optim/bnn.py; the latent path packs the current latent on every
forward (kernels/ops.binary_dense), so it never reads a stale copy. At
deploy time ``pack_for_inference`` drops the latent for the packed sign
words ``w_packed`` (N, K/32) — Table II's 16x memory cut.

A per-output ``scale`` (init 1/sqrt(K)) maps the integer dot back to unit
variance; the paper's MLP relies on its BatchNorm instead (scale=False).

The LM serving path keeps both: ``with_packed`` adds ``w_packed`` once, when
the model is created or loaded, and serving reads only that copy.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.binarize import pack_bits, packed_len
from repro_torch.kernels import ops


def binary_dense_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
                      device, scale: bool = True, dtype=torch.float32) -> dict:
    """w_latent ~ U(-1, 1), as repro draws it (from torch's generator, so
    not the same numbers)."""
    w = torch.rand((in_dim, out_dim), generator=generator, device=device) * 2 - 1
    p = {"w_latent": w.to(dtype)}
    if scale:
        p["scale"] = torch.full((out_dim,), 1.0 / math.sqrt(in_dim),
                                dtype=torch.float32, device=device)
    return p


def binary_dense_apply(p: dict, x: torch.Tensor, *, mode: str = "xnor") -> torch.Tensor:
    """Latent-weight path (training and eval with latents)."""
    y = ops.binary_dense(x, p["w_latent"], mode=mode)
    if "scale" in p:
        y = y * p["scale"]
    return y.to(x.dtype)


def pack_for_inference(p: dict) -> dict:
    """Latent params -> deploy params (packed sign words, no latent). The
    contraction length K is not a leaf: pass it to binary_dense_apply_packed
    or let it default to x.shape[-1]."""
    q = {"w_packed": pack_bits(p["w_latent"].T)}
    if "scale" in p:
        q["scale"] = p["scale"]
    return q


def with_packed(p: dict) -> dict:
    """The latent params with the packed copy added (the LM's weights,
    packed once at load)."""
    return {**p, **pack_for_inference(p)}


def binary_dense_apply_packed(q: dict, x: torch.Tensor, *, k: int | None = None,
                              mode: str = "xnor") -> torch.Tensor:
    """Packed-weight path. The integer dot comes in x's dtype, before the
    scale, the order of repro's latent path (repro/core/binary_dense.py:36-39)
    that the LM reference runs; in f32 (the MLP) that equals repro's packed
    path exactly."""
    y = ops.binary_dense_packed(x, q["w_packed"], k, mode=mode)
    if "scale" in q:
        y = y * q["scale"]
    return y.to(x.dtype)


def binary_dense_bytes(in_dim: int, out_dim: int) -> int:
    """Deployed weight bytes (packed)."""
    return packed_len(in_dim) * 4 * out_dim
