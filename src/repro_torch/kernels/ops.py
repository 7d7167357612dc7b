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

and their grouped forms for the MoE experts, (G, M, K) x (G, K, N), which
the reference lowers to XLA batched dots, not Pallas, so plain torch here:

  binary_dense_batched(x3, w3)                trainable, STE backward
  binary_dense_batched_deployed(x3, wq)       int8 (G, K, N) or packed
                                              (G, N, K/32) expert stacks

Torch has no batched int8 product on a card, so the +-1 operands go to
``torch.bmm`` in bf16 with an f32 output there (exact: the products are
+-1 and every partial sum an integer below 2**24); a bf16 output would
round sums above 256. The CPU has no such overload, and multiplies the
same operands in f32, as exact.
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
    straight-through-estimator backward (paper eq. 2). ``reduce`` sums a
    row-parallel shard's exact dot over the ranks before the cast; the
    backward, given the whole sum's gradient on every rank, is this
    shard's own."""

    @staticmethod
    def forward(ctx, x2d, w, mode, reduce):
        ctx.save_for_backward(x2d, w)
        y = _matmul_packed(x2d, pack_bits(w.T), x2d.shape[1], mode)
        if reduce is not None:
            y = reduce(y)
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
        return gx.to(x.dtype), gw.to(w.dtype), None, None


def binary_dense(x: torch.Tensor, w_latent: torch.Tensor, *,
                 mode: str = "xnor", reduce=None) -> torch.Tensor:
    """Trainable binary dense: x (..., K), w_latent (K, N) -> (..., N) in
    x's dtype = sign(x) @ sign(w), STE backward. The latent is packed anew
    on every call, so an optimizer step is seen at the next forward.
    ``reduce`` maps the exact (M, N) dot before the cast, as in
    binary_dense_packed."""
    mode = resolve_impl(mode)
    lead = x.shape[:-1]
    y = _BinaryDense.apply(x.reshape(-1, x.shape[-1]), w_latent, mode, reduce)
    return y.reshape(*lead, -1)


def binary_dense_packed(x: torch.Tensor, w_packed: torch.Tensor, k: int | None = None,
                        *, mode: str = "xnor", reduce=None) -> torch.Tensor:
    """Inference: x (..., K), w_packed (N, Kp) int32 sign words as packed at
    deploy or load time -> (..., N) in x's dtype, as binary_dense returns
    it: exact in f32 (where repro's f32 result is the same); in bf16 the one
    cast rounds |values| > 256, as repro's latent path does. ``reduce``
    maps the exact (M, N) dot before that cast: a row-parallel shard's
    partial dot summed over the ranks, still exact."""
    mode = resolve_impl(mode)
    k = k if k is not None else x.shape[-1]
    lead = x.shape[:-1]
    y = _matmul_packed(x.reshape(-1, k), w_packed, k, mode)
    if reduce is not None:
        y = reduce(y)
    return y.to(x.dtype).reshape(*lead, -1)


# ---------------------------------------------------------------------------
# grouped (batched) binary dense: the MoE experts, (G, M, K) x (G, K, N)
# ---------------------------------------------------------------------------

def _sign_bmm(sx: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """(G, M, K) x (G, K, N) of +-1 values -> their exact integer products
    in f32 (module note)."""
    if sx.device.type == "cuda":
        return torch.bmm(sx.to(torch.bfloat16), sw.to(torch.bfloat16),
                         out_dtype=torch.float32)
    return torch.bmm(sx.to(torch.float32), sw.to(torch.float32))


def _signs(x: torch.Tensor) -> torch.Tensor:
    """+-1 (sign(0) = +1) in bf16, written in one pass: the expert stacks
    are GBs, and an f32 intermediate would triple the traffic."""
    one = torch.ones((), dtype=torch.bfloat16, device=x.device)
    return torch.where(x >= 0, one, -one)


class _BinaryDenseBatched(torch.autograd.Function):
    """repro/kernels/ops.py:153-170: sign(x) @ sign(w) per group beside the
    STE backward, the same for every mode (the modes' integers agree)."""

    @staticmethod
    def forward(ctx, x3, w3):
        ctx.save_for_backward(x3, w3)
        return _sign_bmm(_signs(x3), _signs(w3))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        sw = torch.where(w >= 0, 1.0, -1.0).to(torch.float32)
        sx = torch.where(x >= 0, 1.0, -1.0).to(torch.float32)
        gx = torch.bmm(g, sw.transpose(1, 2)) * (x.abs() <= 1.0)
        gw = torch.bmm(sx.transpose(1, 2), g) * (w.abs() <= 1.0)
        return gx.to(x.dtype), gw.to(w.dtype)


def binary_dense_batched(x3: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """Grouped trainable binary dense: (G, M, K) x (G, K, N) -> (G, M, N) f32,
    exact integers, the same for every binary mode. repro takes both operands
    in f32 first; their signs and hardtanh windows are the same in any float
    type, and the gradients come back in each operand's dtype, so the (large)
    expert stacks are not cast."""
    return _BinaryDenseBatched.apply(x3, w3)


def binary_dense_batched_deployed(x3: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Deployed grouped binary dense, forward only: wq (G, K, N) +-1 int8
    (int8 mode), or (G, N, K/32) int32 packed sign words (xnor mode) ->
    (G, M, N) f32, exact."""
    if wq.dtype == torch.int32:
        sw = unpack_bits(wq, x3.shape[-1], torch.bfloat16).transpose(1, 2)
    else:
        sw = wq
    return _sign_bmm(_signs(x3), sw)
