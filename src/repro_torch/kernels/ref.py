"""Oracles for the binary and float products, in plain torch.

Port of repro/kernels/ref.py. torch has no popcount, so the XNOR form
counts bits with the SWAR trick on the int32 view of the packed words.
These are the plain versions the CUDA kernels are held against, so they
run on the card as well as on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.core.binarize import LANE_BITS, pack_bits

# rows of pa per step of binary_matmul_packed_ref: its (rows, N, Kp) int32
# temporaries stay near 4M elements (16 MB) whatever the shape
_XOR_ELEMS = 1 << 22


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (given as int32) -> int32. The shifts
    are arithmetic: the first two masks drop the copies of the sign bit, and
    from the third step on every field is small, so bit 31 is 0; the first
    subtraction wraps as unsigned arithmetic would."""
    v = x - ((x >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = v + (v >> 8)
    return (v + (v >> 16)) & 0x3F


def binary_matmul_packed_ref(pa: torch.Tensor, pw: torch.Tensor, k: int) -> torch.Tensor:
    """pa (M, Kp), pw (N, Kp) packed words -> (M, N) int32 =
    K - 2 * popcount(pa xor pw); the +1 pad bits of both operands cancel."""
    m, n, kp = pa.shape[0], pw.shape[0], pa.shape[1]
    rows = max(1, _XOR_ELEMS // max(1, n * kp))
    out = torch.empty((m, n), dtype=torch.int32, device=pa.device)
    for i in range(0, m, rows):
        x = torch.bitwise_xor(pa[i:i + rows, None, :], pw[None, :, :])
        out[i:i + rows] = k - 2 * popcount32(x).sum(dim=-1, dtype=torch.int32)
    return out


def int8_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 x w (N, K) int8 -> (M, N) int32, exact (int64 sums)."""
    return (a.to(torch.int64) @ w.to(torch.int64).T).to(torch.int32)


def bf16_matmul_ref(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (M, K) x w (K, N), both rounded to bf16 -> (M, N) f32: the f32
    product of the bf16 values (no TF32: torch's default for f32 matmuls)."""
    return a.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def hybrid_dense_ref(pa: torch.Tensor, pw: torch.Tensor, scale: torch.Tensor,
                     shift: torch.Tensor, k: int) -> torch.Tensor:
    """Fused binary dense + affine + sign + re-pack.

    pa (M, Kp), pw (N, Kp) int32 words, scale/shift (N,) f32 -> (M, N / 32)
    int32 words of the bits (dot * scale + shift >= 0). The product and the
    sum round separately, as in repro (sign(hardtanh(y)) == sign(y), so the
    clamp does not change the bit)."""
    n = pw.shape[0]
    if n % LANE_BITS:
        raise ValueError(f"hybrid_dense needs N % 32 == 0, got N = {n}")
    dot = binary_matmul_packed_ref(pa, pw, k).to(torch.float32)
    return pack_bits(dot * scale.to(torch.float32) + shift.to(torch.float32))
