"""int8 activations times bit-packed +-1 weights -> exact int32.

Replaces the TPU kernel ``repro/kernels/int8_matmul.py::int8_matmul_pallas``
(B2) with the CUDA kernel in ``csrc/int8_matmul.cu``: int8 tensor cores
fed by a ``cp.async`` ring of activation and packed weight tiles, the
weight expanded from bits on chip, so it crosses device memory at 1 bit
per value. What bounds it on an H100 is noted at the top of that file: at
decode the bytes of the packed weight, at prefill the 2*M*N*K int8
operations.

One call is one launch of one of two designs, chosen by ``plan`` on the
host: the prefill design (M > 16: ``wgmma`` on 128 x 128 output tiles)
or the decode design (M <= 16: ``mma.sync`` on 16 x 64 tiles). Either may
split the K range over a thread block cluster of 2, 4 or 8 blocks whose
partial sums meet in distributed shared memory: at decode so that a call
spreads its weight read over at least two blocks per SM, at prefill where
the output tiles alone would leave SMs idle.

Unlike the TPU kernel, which asserts that its blocks divide M, N and K
(and so cannot take ``bin_out``'s K = 6912 at its default bk = 512), the
CUDA kernel takes any M, any N and any K that is a multiple of 32, and is
exact for every int8 activation, not only +-1.

``int8_matmul`` runs the kernel for a CUDA tensor and its plain version,
``int8_matmul_plain``, for a CPU tensor; for a CUDA tensor it launches the
kernel or raises. ``int8_matmul.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.binarize import LANE_BITS, unpack_bits
from repro_torch.kernels.ksplit import cheapest_split, splits_for, sm_count


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
    here (every partial sum is an integer of magnitude <= 128 K < 2**24)."""
    _check(a, pw)
    w = unpack_bits(pw, a.shape[1], torch.float32)           # (N, K)
    return (a.to(torch.float32) @ w.T).round().to(torch.int32)


PREFILL, DECODE = 0, 1  # the kernel's two designs
DECODE_MAX_M = 16       # the decode design pads M to one m16 tile
TILES = {PREFILL: (128, 128), DECODE: (16, 64)}   # (rows, columns) per block
STAGE_WORDS = 4          # packed words per kernel stage (128 values of K)
SPLIT_COST = 4           # a split's reduction, in stages, per doubling
PREFILL_SLOTS = 2        # prefill blocks an SM holds (its launch bounds)


def plan(m: int, n: int, k: int, n_sms: int = 132) -> tuple[int, int]:
    """The launch: (design, kchunk). The decode design for M <= 16, else
    the prefill design; the K range is cut into chunks of ``kchunk``
    packed words, one block of a thread block cluster each, cut only at
    stage boundaries (multiples of 4 words), so that 16-byte loads stay
    aligned and every chunk but the last is whole. Only splits into 1, 2,
    4 or 8 chunks are taken (``ksplit.splits_for``).

    Decode takes the fewest chunks that give three blocks per SM over the
    N tiles: the call is bound by one pass over the packed weight, which
    wants every SM reading. Prefill takes the split with the least
    (rounds of blocks over the card's block slots, two an SM) x (stages
    a block runs + the reduction, SPLIT_COST stages per doubling;
    ``ksplit.cheapest_split``): a split
    pays where the output tiles alone would leave slots idle or the last
    round thin. The model and its cost were fitted to split sweeps on the
    H100 (PERF.md, PR 15)."""
    kp = k // LANE_BITS
    units = max(1, -(-kp // STAGE_WORDS))
    design = DECODE if m <= DECODE_MAX_M else PREFILL
    bm, bn = TILES[design]
    tiles = -(-m // bm) * -(-n // bn)
    if design == DECODE:
        splits = splits_for(units)
        s = next((s for s in splits if tiles * s >= 3 * n_sms), splits[-1])
    else:
        s = cheapest_split(tiles, units, n_sms, PREFILL_SLOTS, SPLIT_COST)
    return design, STAGE_WORDS * -(-units // s)


def _lib():
    from repro_torch.kernels import build
    lib = build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int8_matmul(a: torch.Tensor, pw: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 (+-1 on the serving path), pw (N, K/32) int32 packed
    signs -> (M, N) int32 = a @ unpack(pw).T."""
    _check(a, pw)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, pw)
    if a.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not {a.device}")
    m, k = a.shape
    out = _launch(a, pw, *plan(m, pw.shape[0], k, sm_count(a.device)))
    int8_matmul.launches += 1
    return out


def _launch(a: torch.Tensor, pw: torch.Tensor, design: int, kchunk: int) -> torch.Tensor:
    """One launch of the kernel with a given plan (``int8_matmul`` passes
    ``plan``'s; chip_smoke.py times the other splits beside it)."""
    if not (a.is_contiguous() and pw.is_contiguous()):
        raise ValueError("int8_matmul takes contiguous tensors")
    if a.data_ptr() % 16 or pw.data_ptr() % 16:
        raise ValueError("int8_matmul stages 16-byte chunks: a and pw must be "
                         "16-byte aligned")
    m, k = a.shape
    n = pw.shape[0]
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(a.data_ptr(), pw.data_ptr(), out.data_ptr(), m, n, k, design, kchunk,
                 stream), "int8_matmul")
    return out


int8_matmul.launches = 0
