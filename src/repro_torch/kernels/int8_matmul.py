"""+-1 int8 activations times bit-packed weights -> exact int32.

Replaces the TPU kernel ``repro/kernels/int8_matmul.py::int8_matmul_pallas``
(B2) with the CUDA kernel in ``csrc/int8_matmul.cu``. What bounds it on an
H100, and how the kernel is laid out, is noted at the top of that file: at
decode it is bound by the bytes of the packed weight, at prefill by the
2*M*N*K int8 operations.

Unlike the TPU kernel, which asserts that its blocks divide M, N and K
(and so cannot take ``bin_out``'s K = 6912 at its default bk = 512), the
CUDA kernel takes any M, any N and any K that is a multiple of 32.

``int8_matmul`` runs the kernel for a CUDA tensor and its plain version,
``int8_matmul_plain``, for a CPU tensor; for a CUDA tensor it launches the
kernel or raises. ``int8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.binarize import LANE_BITS, unpack_bits


def _check(a: torch.Tensor, pw: torch.Tensor) -> None:
    if a.dim() != 2 or pw.dim() != 2:
        raise ValueError(f"int8_matmul takes a (M, K) and pw (N, K/32), got "
                         f"{tuple(a.shape)} and {tuple(pw.shape)}")
    if a.dtype != torch.int8 or pw.dtype != torch.int32:
        raise TypeError(f"int8_matmul takes int8 activations and int32 packed "
                        f"words, got {a.dtype} and {pw.dtype}")
    k = a.shape[1]
    if pw.shape[1] * LANE_BITS != k:
        raise ValueError(f"K = {k} must be 32 x the packed width {pw.shape[1]}")
    if a.device != pw.device:
        raise ValueError(f"a on {a.device}, pw on {pw.device}")


def int8_matmul_plain(a: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """Plain torch version: unpack to +-1 and multiply in f32, which is exact
    here (every partial sum is an integer of magnitude <= K < 2**24)."""
    _check(a, pw)
    w = unpack_bits(pw, a.shape[1], torch.float32)           # (N, K)
    return (a.to(torch.float32) @ w.T).round().to(torch.int32)


def _lib():
    from repro_torch.kernels import build
    lib = build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_matmul(a: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 in {-1, +1}, pw (N, K/32) int32 packed signs ->
    (M, N) int32 = a @ unpack(pw).T."""
    _check(a, pw)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, pw)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and pw.is_contiguous()):
        raise ValueError("int8_matmul takes contiguous tensors")
    if a.data_ptr() % 4:
        raise ValueError("int8_matmul reads activations as 32-bit words: "
                         "a must be 4-byte aligned")
    m, k = a.shape
    n = pw.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(a.data_ptr(), pw.data_ptr(), out.data_ptr(), m, n, k, stream),
          "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0
