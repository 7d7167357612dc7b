"""Fused binary dense layer: XNOR-popcount dot -> affine -> sign -> repack
(BEANNA's dataflow step 9).

Replaces the TPU kernel ``repro/kernels/hybrid_dense.py::hybrid_dense_pallas``
(B5) with the CUDA kernel in ``csrc/hybrid_dense.cu``; what bounds it and
how it is laid out is noted at the top of that file. No path of the model
calls it, in the port as in the reference (``mlp_apply_packed`` runs the
dot, BatchNorm, hardtanh and the next layer's packing as separate steps:
folding BatchNorm into one (scale, shift) rounds differently).

The TPU kernel asserts that its row block divides M; the CUDA kernel masks
ragged M. N % 32 == 0 stays a precondition: the output packs 32 columns to
a word.

``hybrid_dense`` runs the kernel for a CUDA tensor and its plain version,
``hybrid_dense_plain`` (``ref.hybrid_dense_ref``), for a CPU tensor; for a
CUDA tensor it launches the kernel or raises. ``hybrid_dense.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.binarize import LANE_BITS, packed_len
from repro_torch.kernels.ref import hybrid_dense_ref


def _check(pa, pw, scale, shift, k: int) -> None:
    if pa.dim() != 2 or pw.dim() != 2:
        raise ValueError(f"hybrid_dense takes pa (M, Kp) and pw (N, Kp), got "
                         f"{tuple(pa.shape)} and {tuple(pw.shape)}")
    if pa.dtype != torch.int32 or pw.dtype != torch.int32:
        raise TypeError(f"hybrid_dense takes int32 packed words, got "
                        f"{pa.dtype} and {pw.dtype}")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError(f"hybrid_dense takes f32 scale and shift, got "
                        f"{scale.dtype} and {shift.dtype}")
    n = pw.shape[0]
    if n % LANE_BITS:
        raise ValueError(f"hybrid_dense needs N % 32 == 0, got N = {n}")
    if tuple(scale.shape) != (n,) or tuple(shift.shape) != (n,):
        raise ValueError(f"scale and shift must be ({n},), got "
                         f"{tuple(scale.shape)} and {tuple(shift.shape)}")
    if not pa.shape[1] == pw.shape[1] == packed_len(k):
        raise ValueError(f"K = {k} packs to {packed_len(k)} words, got pa "
                         f"{tuple(pa.shape)} and pw {tuple(pw.shape)}")
    if len({t.device for t in (pa, pw, scale, shift)}) != 1:
        raise ValueError("hybrid_dense takes all four tensors on one device")


def hybrid_dense_plain(pa, pw, scale, shift, k: int) -> torch.Tensor:
    """Plain torch version: the SWAR popcount dot, f32 product then sum,
    packed with pack_bits."""
    _check(pa, pw, scale, shift, k)
    return hybrid_dense_ref(pa, pw, scale, shift, k)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("hybrid_dense").hybrid_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def hybrid_dense(pa: torch.Tensor, pw: torch.Tensor, scale: torch.Tensor,
                 shift: torch.Tensor, k: int) -> torch.Tensor:
    """pa (M, Kp), pw (N, Kp) int32 words, scale/shift (N,) f32 ->
    (M, N / 32) int32 words of the bits (dot * scale + shift >= 0)."""
    _check(pa, pw, scale, shift, k)
    if pa.device.type == "cpu":
        return hybrid_dense_plain(pa, pw, scale, shift, k)
    if pa.device.type != "cuda":
        raise ValueError(f"hybrid_dense runs on cuda or cpu, not {pa.device}")
    if not all(t.is_contiguous() for t in (pa, pw, scale, shift)):
        raise ValueError("hybrid_dense takes contiguous tensors")
    m, kp = pa.shape
    n = pw.shape[0]
    out = torch.empty((m, n // LANE_BITS), dtype=torch.int32, device=pa.device)
    stream = torch.cuda.current_stream(pa.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(pa.data_ptr(), pw.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 out.data_ptr(), m, n, kp, k, stream), "hybrid_dense")
    hybrid_dense.launches += 1
    return out


hybrid_dense.launches = 0
