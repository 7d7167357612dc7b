"""Oracles for the binary products, in plain torch.

Port of repro/kernels/ref.py (the parts this slice runs). torch has no
popcount, so the XNOR form counts bits with the SWAR trick on the int32
view of the packed words, widened to int64 so no shift meets a sign bit.
"""

from __future__ import annotations

import torch


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (given as int32) -> int32."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def binary_matmul_packed_ref(pa: torch.Tensor, pw: torch.Tensor, k: int) -> torch.Tensor:
    """pa (M, Kp), pw (N, Kp) packed words -> (M, N) int32 =
    K - 2 * popcount(pa xor pw); the +1 pad bits of both operands cancel."""
    x = torch.bitwise_xor(pa[:, None, :], pw[None, :, :])
    pc = popcount32(x).sum(dim=-1, dtype=torch.int32)
    return (k - 2 * pc).to(torch.int32)


def int8_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 x w (N, K) int8 -> (M, N) int32, exact (int64 sums)."""
    return (a.to(torch.int64) @ w.to(torch.int64).T).to(torch.int32)
