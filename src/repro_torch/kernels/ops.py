"""Dispatch layer over the binary products (port of repro/kernels/ops.py).

The logical op is  y = sign(x) @ sign(w)  with the weight packed once, at
load time, to (N, K/32) words (repro packs on every call; the numbers are
the same). One lowering per binary mode:

  mode "int8"   +-1 int8 activations against the packed weight through
                kernels/int8_matmul.int8_matmul: the CUDA kernel for a CUDA
                tensor, its plain version for a CPU tensor
  mode "bf16"   a plain float matmul of the sign matrices (float ablation,
                the same integer values)
  mode "xnor"   the XNOR-popcount kernel (B1): not ported yet

The straight-through-estimator backward (repro's custom_vjp) comes with
the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import pack_signs_int8, unpack_bits
from repro_torch.kernels.int8_matmul import int8_matmul

BINARY_MODES = ("int8", "bf16")


def resolve_impl(mode: str) -> str:
    """mode -> the lowering binary_dense runs. Which device runs it is the
    kernel wrapper's choice, made from where the tensor lies."""
    if mode == "xnor":
        raise NotImplementedError(
            "binary_mode='xnor' needs the XNOR-popcount kernel, ROADMAP B1 "
            "(ported with queue item A2)")
    if mode not in BINARY_MODES:
        raise ValueError(f"unknown binary mode {mode!r}")
    return mode


def binary_dense(x: torch.Tensor, w_packed: torch.Tensor, *,
                 mode: str = "int8") -> torch.Tensor:
    """x (..., K), w_packed (N, K/32) int32 sign words -> (..., N) in x's
    dtype: exact in f32; bf16 rounds |values| > 256, as repro does."""
    mode = resolve_impl(mode)
    lead, k = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, k)
    if mode == "int8":
        y = int8_matmul(pack_signs_int8(x2d), w_packed)
    else:
        sx = torch.where(x2d >= 0, 1.0, -1.0).to(torch.float32)
        # f32 is exact here: sums of +-1 stay far below 2**24
        y = sx @ unpack_bits(w_packed, k, torch.float32).T
    # int32 -> activation dtype first, as repro/kernels/ops.py:75 does
    return y.to(x.dtype).reshape(*lead, -1)
