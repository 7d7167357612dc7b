"""Fused binary dense layer: XNOR-popcount dot -> affine -> sign -> repack
(BEANNA's dataflow step 9).

Replaces the TPU kernel ``repro/kernels/hybrid_dense.py::hybrid_dense_pallas``
(B5) with the CUDA kernel in ``csrc/hybrid_dense.cu``: B1's main loop (the
tensor cores' 1-bit product, ``mma.sync`` m16n8k256 b1 AND-popc with the
rows' popcounts folded in, fed by a ``cp.async`` ring), with the affine,
the sign and the repacking into words in its epilogue, in registers. What
bounds it on an H100, and how the kernel is laid out, is noted at the top
of that file. No path of the model calls it, in the port as in the
reference (``mlp_apply_packed`` runs the dot, BatchNorm, hardtanh and the
next layer's packing as separate steps: folding BatchNorm into one (scale,
shift) rounds differently).

One call is one launch, its K range split over a thread block cluster of
1, 2, 4 or 8 blocks where ``plan`` (on the host) finds that it pays; the
cluster adds the integer partials before the epilogue, so every split gives
the same bits.

The TPU kernel asserts that its row block divides M; the CUDA kernel masks
ragged M and takes any K. N % 32 == 0 stays a precondition: the output
packs 32 columns to a word.

``hybrid_dense`` runs the kernel for a CUDA tensor and its plain version,
``hybrid_dense_plain`` (``ref.hybrid_dense_ref``), for a CPU tensor; for a
CUDA tensor it launches the kernel or raises. ``hybrid_dense.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.binarize import LANE_BITS, packed_len
from repro_torch.kernels import binary_matmul
from repro_torch.kernels.ksplit import sm_count
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


TILE = (32, 64)           # (rows, columns) of outputs per block: two words of 32 rows
STAGE_WORDS = binary_matmul.STAGE_WORDS


def plan(m: int, n: int, k: int, n_sms: int = 132) -> int:
    """The launch's ``kchunk``: B1's plan over this kernel's tiles, with
    B1's stages and split costs, since the two run the same main loop. On
    the H100 the MNIST layers' 4 stages (K = 1024) ran fastest in one chunk
    at every batch; at a K of 2560 (10 stages, past the 8-stage ring) the
    plan's 2 chunks ran 1.2x faster than one, 4 chunks 1.1x faster still
    (PERF.md section 6; no split cost of ``ksplit``'s model picks 4 there
    and 1 at K = 1024)."""
    return binary_matmul.plan(m, n, k, n_sms, TILE)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("hybrid_dense").hybrid_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    out = _launch(pa, pw, scale, shift, k,
                  plan(pa.shape[0], pw.shape[0], k, sm_count(pa.device)))
    hybrid_dense.launches += 1
    return out


def _launch(pa, pw, scale, shift, k: int, kchunk: int) -> torch.Tensor:
    """One launch of the kernel with a given plan (``hybrid_dense`` passes
    ``plan``'s; the tests and chip_smoke.py run the others beside it)."""
    tensors = (pa, pw, scale, shift)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("hybrid_dense takes contiguous tensors")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("hybrid_dense stages 16-byte chunks: pa, pw, scale and shift "
                         "must be 16-byte aligned")
    m, kp = pa.shape
    n = pw.shape[0]
    out = torch.empty((m, n // LANE_BITS), dtype=torch.int32, device=pa.device)
    stream = torch.cuda.current_stream(pa.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(pa.data_ptr(), pw.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                 out.data_ptr(), m, n, kp, k, kchunk, stream), "hybrid_dense")
    return out


hybrid_dense.launches = 0
