"""bf16 GEMM with f32 accumulation and an optional hardtanh epilogue
(BEANNA's float mode).

Replaces the TPU kernel ``repro/kernels/bf16_matmul.py::bf16_matmul_pallas``
(B6) with the CUDA kernel in ``csrc/bf16_matmul.cu``: bf16 tensor cores
(``wgmma`` m64n64k16 on 64 x 64 tiles, ``mma.sync`` m16n8k16 on 16 x 8
ones; f32 accumulators) fed by a ``cp.async`` ring; what bounds it and how
it is laid out is noted at the top of that file. No path of the model
calls it, in the port as in the reference: the MNIST net's float layers
stay f32 (``nn.dense_apply``).

One call is one launch of one of two tile designs, with the K range
split over a thread block cluster of 1, 2, 4 or 8 blocks whose partial
tiles are added in a fixed order (two calls give the same bits); ``plan``
picks both on the host.

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

from repro_torch.kernels.ksplit import cheapest_split, sm_count
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


LARGE, SMALL = 0, 1           # the kernel's tile designs
TILES = {LARGE: (64, 64), SMALL: (16, 8)}   # (rows, columns) of outputs per block
STAGE_K = 64                  # values of K per kernel stage
SPLIT_COST = 1                # a split's reduction, in stages, per doubling
SLOTS = 3                     # LARGE blocks an SM holds (70,656 B of shared memory each)


def plan(m: int, n: int, k: int, n_sms: int = 132) -> tuple[int, int]:
    """The launch: (design, kchunk). The K range is cut into chunks of
    ``kchunk`` values, one block of a thread block cluster each, at stage
    boundaries (multiples of 64), so that every chunk but the last is
    whole; the split is ``ksplit.cheapest_split``'s.

    SMALL where M <= 16 or N <= 16 (M = 1, fc3's N = 10), else LARGE. A
    stage moves 16 KB into a LARGE block, so at the MNIST shapes a split
    pays until every SM has a block, and stops paying where the blocks
    would need a second round (fc1's 64 tiles x 8 chunks). The costs were
    fitted to sweeps of every design and split on the H100 (PERF.md
    section 6)."""
    units = -(-k // STAGE_K)
    design = SMALL if m <= 16 or n <= 16 else LARGE
    bm, bn = TILES[design]
    tiles = -(-m // bm) * -(-n // bn)
    return design, STAGE_K * -(-units // cheapest_split(tiles, units, n_sms, SLOTS, SPLIT_COST))


def _lib():
    from repro_torch.kernels import build
    fn = build.load("bf16_matmul").bf16_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
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
    m, k = a.shape
    out = _launch(a, w, hardtanh, *plan(m, w.shape[1], k, sm_count(a.device)))
    bf16_matmul.launches += 1
    return out


def _launch(a: torch.Tensor, w: torch.Tensor, hardtanh: bool, design: int,
            kchunk: int) -> torch.Tensor:
    """One launch of the kernel with a given plan (``bf16_matmul`` passes
    ``plan``'s; the tests and chip_smoke.py run the others beside it)."""
    if not (a.is_contiguous() and w.is_contiguous()):
        raise ValueError("bf16_matmul takes contiguous tensors")
    if a.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("bf16_matmul stages 16-byte chunks: a and w must be "
                         "16-byte aligned")
    m, k = a.shape
    n = w.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(a.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, int(hardtanh), design,
                 kchunk, stream), "bf16_matmul")
    return out


bf16_matmul.launches = 0
