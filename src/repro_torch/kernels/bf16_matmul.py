"""bf16 GEMM with f32 accumulation and an optional hardtanh epilogue
(BEANNA's float mode).

Replaces the TPU kernel ``repro/kernels/bf16_matmul.py::bf16_matmul_pallas``
(B6) with the CUDA kernel in ``csrc/bf16_matmul.cu``; what bounds it and
how it is laid out is noted at the top of that file. No path of the model
calls it, in the port as in the reference: the MNIST net's float layers
stay f32 (``nn.dense_apply``).

The TPU kernel asserts that its blocks divide M, N and K (bk = min(512, K),
so it refuses the MNIST net's first layer, K = 784); the CUDA kernel masks
all three.

``bf16_matmul`` runs the kernel for a CUDA tensor and its plain version,
``bf16_matmul_plain`` (``ref.bf16_matmul_ref``, then the clamp), for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
``bf16_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.ref import bf16_matmul_ref


def _check(a: torch.Tensor, w: torch.Tensor) -> None:
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"bf16_matmul takes a (M, K) and w (K, N), got "
                         f"{tuple(a.shape)} and {tuple(w.shape)}")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"bf16_matmul takes bf16 operands, got {a.dtype} and {w.dtype}")
    if a.device != w.device:
        raise ValueError(f"a on {a.device}, w on {w.device}")


def bf16_matmul_plain(a: torch.Tensor, w: torch.Tensor, *,
                      hardtanh: bool = False) -> torch.Tensor:
    """Plain torch version: the f32 product of the bf16 values."""
    _check(a, w)
    y = bf16_matmul_ref(a, w)
    return torch.clamp(y, -1.0, 1.0) if hardtanh else y


def _lib():
    from repro_torch.kernels import build
    fn = build.load("bf16_matmul").bf16_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bf16_matmul(a: torch.Tensor, w: torch.Tensor, *, hardtanh: bool = False) -> torch.Tensor:
    """a (M, K) bf16 x w (K, N) bf16 -> (M, N) f32, clamped to [-1, 1] when
    ``hardtanh``."""
    _check(a, w)
    if a.device.type == "cpu":
        return bf16_matmul_plain(a, w, hardtanh=hardtanh)
    if a.device.type != "cuda":
        raise ValueError(f"bf16_matmul runs on cuda or cpu, not {a.device}")
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("bf16_matmul takes contiguous tensors")
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, int(hardtanh),
                 stream), "bf16_matmul")
    bf16_matmul.launches += 1
    return out


bf16_matmul.launches = 0
