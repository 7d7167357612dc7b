"""Bit packing of signs, the numerical format of BEANNA's binary layers.

Port of repro/core/binarize.py. Values in {-1, +1} are stored 1 bit each,
bit = 1 <-> +1, 32 to a word along the last axis:

    bit i of word j == 1  <=>  x[..., 32 j + i] >= 0

sign(0) is +1 throughout (the test is ``x >= 0``; ``torch.sign(0)`` is 0
and is not used), and the pad bits of a last partial word are 1 (+1).

torch on the CPU cannot right-shift uint32, so a packed word is held as
the int32 with the same bits. ``(w >> i) & 1`` is still bit i: the shift
is arithmetic, and the mask drops the copies of the sign bit.

Training follows Courbariaux et al., as repro does: the forward uses
sign(latent), the backward the straight-through estimator
d sign(x)/dx ~= 1{|x| <= 1}.
"""

from __future__ import annotations

import torch

LANE_BITS = 32  # bits packed per 32-bit word


class _SignSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def sign_ste(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} (sign(0) := +1), gradient g * 1{|x| <= 1}."""
    return _SignSTE.apply(x)


def hardtanh(x: torch.Tensor) -> torch.Tensor:
    """Paper eq. (3)."""
    return torch.clamp(x, -1.0, 1.0)


def packed_len(k: int) -> int:
    return (k + LANE_BITS - 1) // LANE_BITS


def pack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., K) -> (..., ceil(K / 32)) int32 words of sign bits."""
    k = x.shape[-1]
    kp = packed_len(k)
    pad = kp * LANE_BITS - k
    bits = (x >= 0).to(torch.int64)
    if pad:
        bits = torch.cat([bits, bits.new_ones((*x.shape[:-1], pad))], dim=-1)
    bits = bits.reshape(*x.shape[:-1], kp, LANE_BITS)
    shifts = torch.arange(LANE_BITS, dtype=torch.int64, device=x.device)
    words = (bits << shifts).sum(dim=-1)               # in [0, 2**32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(p: torch.Tensor, k: int, dtype=torch.float32) -> torch.Tensor:
    """Inverse of pack_bits: (..., Kp) int32 words -> (..., k) in {-1, +1}."""
    shifts = torch.arange(LANE_BITS, dtype=torch.int32, device=p.device)
    bits = (p.unsqueeze(-1) >> shifts) & 1
    bits = bits.reshape(*p.shape[:-1], p.shape[-1] * LANE_BITS)[..., :k]
    return (bits.to(dtype) * 2 - 1).to(dtype)


def pack_signs_int8(x: torch.Tensor) -> torch.Tensor:
    """sign(x) as int8 in {-1, +1} (what the int8 kernel multiplies)."""
    return (x >= 0).to(torch.int8) * 2 - 1


def binary_dot_packed(pa: torch.Tensor, pw: torch.Tensor, k: int) -> torch.Tensor:
    """dot of +-1 vectors from packed bits: pa (..., M, Kp), pw (N, Kp) int32
    words -> (..., M, N) int32 = K - 2 * popcount(pa xor pw). The +1 pad
    bits are equal in both operands, so they add nothing to the count."""
    from repro_torch.kernels.ref import binary_matmul_packed_ref
    lead = pa.shape[:-2]
    out = binary_matmul_packed_ref(pa.reshape(-1, pa.shape[-1]), pw, k)
    if lead:
        out = out.reshape(*lead, pa.shape[-2], pw.shape[0])
    return out


def binary_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Float oracle: sign(a) @ sign(w).T for a (M, K), w (N, K) -> (M, N)
    f32, exact (sums of +-1 stay far below 2**24)."""
    sa = torch.where(a >= 0, 1.0, -1.0).to(torch.float32)
    sw = torch.where(w >= 0, 1.0, -1.0).to(torch.float32)
    return sa @ sw.T
