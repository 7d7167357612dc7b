"""XNOR-popcount matmul of bit-packed signs -> exact int32 (BEANNA's binary
mode).

Replaces the TPU kernel ``repro/kernels/binary_matmul.py::binary_matmul_pallas``
(B1) with the CUDA kernel in ``csrc/binary_matmul.cu``: the tensor cores'
1-bit product (``mma.sync`` m16n8k256 b1, AND-popc, with the popcounts of
the rows folded in to give the XNOR count), fed by a ``cp.async`` ring.
What bounds it on an H100, and how the kernel is laid out, is noted at the
top of that file: at the MNIST net's shapes it is bound by bytes, most of
them its int32 output, and in practice by the latency of one small launch.

One call is one launch, its K range split over a thread block cluster of
1, 2, 4 or 8 blocks where ``plan`` (on the host) finds that it pays.

Unlike the TPU kernel, which asserts that its blocks divide M, N and Kp
(and so refuses K = 384, where Kp = 12 and bk = 8), the CUDA kernel takes
any M, any N and any K.

``binary_matmul`` runs the kernel for a CUDA tensor and its plain version,
``binary_matmul_plain`` (the SWAR popcount of ``ref.binary_matmul_packed_ref``),
for a CPU tensor; for a CUDA tensor it launches the kernel or raises.
``binary_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.binarize import packed_len
from repro_torch.kernels.ksplit import cheapest_split, sm_count
from repro_torch.kernels.ref import binary_matmul_packed_ref


def _check(pa: torch.Tensor, pw: torch.Tensor, k: int) -> None:
    if pa.dim() != 2 or pw.dim() != 2:
        raise ValueError(f"binary_matmul takes pa (M, Kp) and pw (N, Kp), got "
                         f"{tuple(pa.shape)} and {tuple(pw.shape)}")
    if pa.dtype != torch.int32 or pw.dtype != torch.int32:
        raise TypeError(f"binary_matmul takes int32 packed words, got "
                        f"{pa.dtype} and {pw.dtype}")
    if not pa.shape[1] == pw.shape[1] == packed_len(k):
        raise ValueError(f"K = {k} packs to {packed_len(k)} words, got pa "
                         f"{tuple(pa.shape)} and pw {tuple(pw.shape)}")
    if pa.device != pw.device:
        raise ValueError(f"pa on {pa.device}, pw on {pw.device}")


def binary_matmul_plain(pa: torch.Tensor, pw: torch.Tensor, k: int) -> torch.Tensor:
    """Plain torch version: K - 2 * popcount(pa xor pw), counted with SWAR."""
    _check(pa, pw, k)
    return binary_matmul_packed_ref(pa, pw, k)


TILE = (32, 32)           # (rows, columns) of outputs per block
STAGE_WORDS = 8           # packed words per kernel stage (one k256 step)
SPLIT_COST = 3            # a split's reduction, in stages, per doubling
SLOTS = 4                 # blocks an SM is counted to hold


def plan(m: int, n: int, k: int, n_sms: int = 132,
         tile: tuple[int, int] = TILE) -> int:
    """The launch's ``kchunk``: the K range is cut into chunks of that many
    packed words, one block of a thread block cluster each, at stage
    boundaries (multiples of 8 words), so that every chunk but the last is
    whole; the split is ``ksplit.cheapest_split``'s over blocks of ``tile``
    outputs (B5, ``hybrid_dense``, runs this main loop on its own tiles).

    On the H100 one call at the MNIST shapes is one round trip to memory
    whatever its grid: 32 blocks (M = 1) ran as fast as 256 blocks of 16 x
    8 outputs, and splitting the 4 stages of K = 1024 only added the
    reduction, while the spec draft's 10 stages (K = 2560) ran fastest in
    2 chunks (PERF.md section 6)."""
    units = -(-packed_len(k) // STAGE_WORDS)
    tiles = -(-m // tile[0]) * -(-n // tile[1])
    return STAGE_WORDS * -(-units // cheapest_split(tiles, units, n_sms, SLOTS, SPLIT_COST))


def _lib():
    from repro_torch.kernels import build
    fn = build.load("binary_matmul").binary_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def binary_matmul(pa: torch.Tensor, pw: torch.Tensor, k: int) -> torch.Tensor:
    """pa (M, Kp), pw (N, Kp) int32 words of packed signs (pad bits 1) ->
    (M, N) int32 = sign(a) @ sign(w).T over the first K signs."""
    _check(pa, pw, k)
    if pa.device.type == "cpu":
        return binary_matmul_plain(pa, pw, k)
    if pa.device.type != "cuda":
        raise ValueError(f"binary_matmul runs on cuda or cpu, not {pa.device}")
    out = _launch(pa, pw, k, plan(pa.shape[0], pw.shape[0], k, sm_count(pa.device)))
    binary_matmul.launches += 1
    return out


def _launch(pa: torch.Tensor, pw: torch.Tensor, k: int, kchunk: int) -> torch.Tensor:
    """One launch of the kernel with a given plan (``binary_matmul`` passes
    ``plan``'s; the tests and chip_smoke.py run the others beside it)."""
    if not (pa.is_contiguous() and pw.is_contiguous()):
        raise ValueError("binary_matmul takes contiguous tensors")
    if pa.data_ptr() % 16 or pw.data_ptr() % 16:
        raise ValueError("binary_matmul stages 16-byte chunks: pa and pw must be "
                         "16-byte aligned")
    m, kp = pa.shape
    n = pw.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=pa.device)
    stream = torch.cuda.current_stream(pa.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(pa.data_ptr(), pw.data_ptr(), out.data_ptr(), m, n, kp, k, kchunk, stream),
          "binary_matmul")
    return out


binary_matmul.launches = 0
