"""Dispatch layer over the binary kernels and the trainable binary dense
(port of repro/kernels/ops.py).

One logical op,  y = sign(x) @ sign(w),  and one lowering per binary mode
(BEANNA's PE mode mux, as a per-layer choice):

  mode "xnor"   packed activations against packed weights through
                kernels/binary_matmul.binary_matmul (B1, XNOR-popcount)
  mode "int8"   +-1 int8 activations against packed weights through
                kernels/int8_matmul.int8_matmul (B2); needs K % 32 == 0
  mode "bf16"   a plain float matmul of the sign matrices (float ablation,
                the same integer values)

Each kernel wrapper runs the CUDA kernel for a CUDA tensor and its plain
version for a CPU tensor.

Two entry points, with repro's names:

  binary_dense(x, w_latent)          trainable: packs the *current* latent
                                     on every call and runs the STE backward
                                     (repro's custom_vjp) as an
                                     autograd.Function
  binary_dense_packed(x, w_packed, k)  inference: weights packed once
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import pack_bits, pack_signs_int8, unpack_bits
from repro_torch.kernels.binary_matmul import binary_matmul
from repro_torch.kernels.int8_matmul import int8_matmul

BINARY_MODES = ("xnor", "int8", "bf16")

# the binarized self-draft's packed lowerings (ModelConfig.spec_draft_impl),
# with repro's names (repro/kernels/ops.py:31); each is one of the modes
SPEC_DRAFT_IMPLS = ("auto", "xla_xnor", "int8_mxu", "pallas_xnor")
_DRAFT_MODES = {"auto": "xnor", "xla_xnor": "xnor", "pallas_xnor": "xnor",
                "int8_mxu": "int8"}


def resolve_impl(mode: str) -> str:
    """mode -> the lowering the binary ops run. Which device runs it is the
    kernel wrapper's choice, made from where the tensor lies."""
    if mode not in BINARY_MODES:
        raise ValueError(f"unknown binary mode {mode!r}")
    return mode


def draft_mode(impl: str) -> str:
    """A ``spec_draft_impl`` -> the binary mode its packed product runs:
    repro's XNOR lowerings ("auto", "xla_xnor", "pallas_xnor") are B1's
    XNOR-popcount product, its +-1 int8 one ("int8_mxu") is B2's, which
    multiplies the same +-1 int8 activations by the packed bits. Each runs
    its kernel for a CUDA tensor and its plain version for a CPU one."""
    if impl not in _DRAFT_MODES:
        raise ValueError(f"unknown spec_draft_impl {impl!r}: expected one of "
                         f"{SPEC_DRAFT_IMPLS}")
    return _DRAFT_MODES[impl]


def _matmul_packed(x2d: torch.Tensor, w_packed: torch.Tensor, k: int,
                   mode: str) -> torch.Tensor:
    """sign(x2d) (M, K) against packed weights (N, Kp) -> (M, N), exact
    integers (int32 from the kernels, f32 from the bf16 lowering)."""
    if mode == "xnor":
        return binary_matmul(pack_bits(x2d), w_packed, k)
    if mode == "int8":
        return int8_matmul(pack_signs_int8(x2d), w_packed)
    sx = torch.where(x2d >= 0, 1.0, -1.0).to(torch.float32)
    # f32 is exact here: sums of +-1 stay far below 2**24
    return sx @ unpack_bits(w_packed, k, torch.float32).T


class _BinaryDense(torch.autograd.Function):
    """repro/kernels/ops.py:78-100: the integer forward beside the
    straight-through-estimator backward (paper eq. 2)."""

    @staticmethod
    def forward(ctx, x2d, w, mode):
        ctx.save_for_backward(x2d, w)
        y = _matmul_packed(x2d, pack_bits(w.T), x2d.shape[1], mode)
        return y.to(x2d.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.to(torch.float32)
        xf = x.to(torch.float32)
        sw = torch.where(w >= 0, 1.0, -1.0).to(torch.float32)
        sx = torch.where(xf >= 0, 1.0, -1.0)
        # grads pass where |.| <= 1 (the hardtanh window); plain f32
        # products, as XLA computes them outside any Pallas kernel
        gx = (gf @ sw.T) * (xf.abs() <= 1.0)
        gw = (sx.T @ gf) * (w.abs() <= 1.0)
        return gx.to(x.dtype), gw.to(w.dtype), None


def binary_dense(x: torch.Tensor, w_latent: torch.Tensor, *,
                 mode: str = "xnor") -> torch.Tensor:
    """Trainable binary dense: x (..., K), w_latent (K, N) -> (..., N) in
    x's dtype = sign(x) @ sign(w), STE backward. The latent is packed anew
    on every call, so an optimizer step is seen at the next forward."""
    mode = resolve_impl(mode)
    lead = x.shape[:-1]
    y = _BinaryDense.apply(x.reshape(-1, x.shape[-1]), w_latent, mode)
    return y.reshape(*lead, -1)


def binary_dense_packed(x: torch.Tensor, w_packed: torch.Tensor, k: int | None = None,
                        *, mode: str = "xnor") -> torch.Tensor:
    """Inference: x (..., K), w_packed (N, Kp) int32 sign words as packed at
    deploy or load time -> (..., N) in x's dtype, as binary_dense returns
    it: exact in f32 (where repro's f32 result is the same); in bf16 the one
    cast rounds |values| > 256, as repro's latent path does."""
    mode = resolve_impl(mode)
    k = k if k is not None else x.shape[-1]
    lead = x.shape[:-1]
    y = _matmul_packed(x.reshape(-1, k), w_packed, k, mode)
    return y.to(x.dtype).reshape(*lead, -1)
