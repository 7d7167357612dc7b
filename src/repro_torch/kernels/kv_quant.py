"""KV-cache quantize / dequantize: BEANNA's binary storage trade applied to
the serving pool's K/V (port of repro/kernels/kv_quant.py).

  int8     per-(token, head) absmax: scale = bf16(absmax / 127), values =
           round(x / f32(scale)) clipped to [-127, 127] as int8 (a zero
           scale divides by 1). D + 2 bytes per head-row against 2D.
  binary   sign bits packed 32 to a word (core/binarize.pack_bits' layout:
           bit = x >= 0, pad bits 1), scale = bf16(mean |x|). Words are
           int32 bit views here, as everywhere in the port (torch on the CPU
           cannot shift uint32); repro stores uint32 with the same bits.

Both quantizers divide by the *stored* bf16 scale, so every later read
dequantizes what the insert wrote. Every function takes (..., D) and works
along the last axis; the dequants compute in f32 and then cast to
``dtype``, as repro's kernels do.

Replaces the TPU kernels B4a-d (``kv_quant_int8_pallas``,
``kv_dequant_int8_pallas``, ``kv_quant_binary_pallas``,
``kv_dequant_binary_pallas``) with the CUDA kernels in ``csrc/kv_quant.cu``
(bound by bytes; see that file). The TPU kernels pad rows to a block; the
CUDA kernels take any row count and any D.

Each wrapper (``kv_quant_int8``, ``kv_dequant_int8``, ``kv_quant_binary``,
``kv_dequant_binary``) runs its kernel for a CUDA tensor and its plain
version (``*_plain``, the port of repro's XLA twin) for a CPU tensor; for a
CUDA tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
kernel launches.

The sum of mean |x| has one fixed order, which the plain version writes out
and the kernel follows (``_lane_sum``), so the two agree bit for bit for f32
inputs too. repro leaves the order to XLA; with bf16 inputs (the serving
path) the bf16-rounded means agree with it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.binarize import LANE_BITS, pack_bits, packed_len, unpack_bits

_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# plain versions (repro's XLA twins)
# ---------------------------------------------------------------------------

def _lane_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the kernel's order: lane l (of 32) adds
    a[l], a[l + 32], ... in index order, then the lanes meet in a tree that
    adds halves, a[..., :16] + a[..., 16:], down to one."""
    d = a.shape[-1]
    pad = packed_len(d) * LANE_BITS - d
    if pad:
        a = torch.cat([a, a.new_zeros((*a.shape[:-1], pad))], dim=-1)
    a = a.reshape(*a.shape[:-1], -1, LANE_BITS)
    acc = a[..., 0, :]
    for w in range(1, a.shape[-2]):
        acc = acc + a[..., w, :]
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def kv_quant_int8_plain(x: torch.Tensor):
    """(..., D) -> (values int8 (..., D), scales bf16 (...,))."""
    xf = x.to(torch.float32)
    scale = (xf.abs().amax(dim=-1) / 127.0).to(torch.bfloat16)
    sf = scale.to(torch.float32)
    sf = torch.where(sf == 0.0, 1.0, sf)
    q = torch.clamp(torch.round(xf / sf[..., None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def kv_dequant_int8_plain(values: torch.Tensor, scales: torch.Tensor,
                          dtype=torch.bfloat16) -> torch.Tensor:
    return (values.to(torch.float32) * scales.to(torch.float32)[..., None]).to(dtype)


def kv_quant_binary_plain(x: torch.Tensor):
    """(..., D) -> (packed int32 (..., ceil(D / 32)), scales bf16 (...,))."""
    xf = x.to(torch.float32)
    scale = (_lane_sum(xf.abs()) / x.shape[-1]).to(torch.bfloat16)
    return pack_bits(xf), scale


def kv_dequant_binary_plain(packed: torch.Tensor, scales: torch.Tensor, d: int,
                            dtype=torch.bfloat16) -> torch.Tensor:
    signs = unpack_bits(packed, d, torch.float32)
    return (signs * scales.to(torch.float32)[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types before the stream (csrc/kv_quant.cu)
_ARGTYPES = {"kv_quant_int8": [_P, _I, _P, _P, _I, _I],
             "kv_quant_binary": [_P, _I, _P, _P, _I, _I],
             "kv_dequant_int8": [_P, _P, _P, _I, _I],
             "kv_dequant_binary": [_P, _P, _P, _I, _I]}
_FNS: dict[str, object] = {}


def _launch(wrapper, *args, device) -> None:
    """Call the C entry point named after ``wrapper`` on the current stream,
    raise on a launch error, and count the launch."""
    name = wrapper.__name__
    fn = _FNS.get(name)
    if fn is None:
        from repro_torch.kernels import build
        fn = getattr(build.load("kv_quant"), f"{name}_launch")
        fn.argtypes = [*_ARGTYPES[name], _P]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    from repro_torch.kernels.build import check
    check(fn(*args, torch.cuda.current_stream(device).cuda_stream), name)
    wrapper.launches += 1


def _on_cuda(t: torch.Tensor, what: str) -> bool:
    """False for a CPU tensor (the plain version runs), True for a CUDA one."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return True


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1]).contiguous()


def _quant(wrapper, x: torch.Tensor, width: int, dtype):
    """Quantize x's rows into (N, width) words of ``dtype`` and bf16 scales
    (N,); returns both shaped by x's leading dims."""
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{wrapper.__name__} takes bf16 or f32 rows on the card, "
                        f"got {x.dtype}")
    x2 = _rows(x)
    n, d = x2.shape
    words = torch.empty((n, width), dtype=dtype, device=x.device)
    scales = torch.empty((n,), dtype=torch.bfloat16, device=x.device)
    if n:
        _launch(wrapper, x2.data_ptr(), int(x.dtype == torch.bfloat16), words.data_ptr(),
                scales.data_ptr(), n, d, device=x.device)
    lead = x.shape[:-1]
    return words.reshape(*lead, width), scales.reshape(lead)


def _dequant(wrapper, words: torch.Tensor, scales: torch.Tensor, d: int, dtype):
    """Dequantize (..., W) words with their (...,) bf16 scales to (..., d)."""
    if scales.dtype != torch.bfloat16 or scales.shape != words.shape[:-1]:
        raise ValueError(f"{wrapper.__name__} takes bf16 scales of shape "
                         f"{tuple(words.shape[:-1])}, got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if scales.device != words.device:
        raise ValueError(f"values on {words.device}, scales on {scales.device}")
    w2, s2 = _rows(words), scales.reshape(-1).contiguous()
    n = w2.shape[0]
    out = torch.empty((n, d), dtype=torch.float32, device=words.device)
    if n:
        _launch(wrapper, w2.data_ptr(), s2.data_ptr(), out.data_ptr(), n, d,
                device=words.device)
    return out.reshape(*words.shape[:-1], d).to(dtype)


def kv_quant_int8(x: torch.Tensor):
    """(..., D) bf16 or f32 -> (values int8 (..., D), scales bf16 (...,))."""
    if not _on_cuda(x, "kv_quant_int8"):
        return kv_quant_int8_plain(x)
    return _quant(kv_quant_int8, x, x.shape[-1], torch.int8)


def kv_dequant_int8(values: torch.Tensor, scales: torch.Tensor, *,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """values int8 (..., D), scales bf16 (...,) -> (..., D) in ``dtype``."""
    if not _on_cuda(values, "kv_dequant_int8"):
        return kv_dequant_int8_plain(values, scales, dtype)
    if values.dtype != torch.int8:
        raise TypeError(f"kv_dequant_int8 takes int8 values, got {values.dtype}")
    return _dequant(kv_dequant_int8, values, scales, values.shape[-1], dtype)


def kv_quant_binary(x: torch.Tensor):
    """(..., D) bf16 or f32 -> (packed int32 (..., ceil(D / 32)), scales bf16)."""
    if not _on_cuda(x, "kv_quant_binary"):
        return kv_quant_binary_plain(x)
    return _quant(kv_quant_binary, x, packed_len(x.shape[-1]), torch.int32)


def kv_dequant_binary(packed: torch.Tensor, scales: torch.Tensor, d: int, *,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """packed int32 (..., ceil(D / 32)), scales bf16 (...,) -> (..., D)."""
    if not _on_cuda(packed, "kv_dequant_binary"):
        return kv_dequant_binary_plain(packed, scales, d, dtype)
    if packed.dtype != torch.int32 or packed.shape[-1] != packed_len(d):
        raise ValueError(f"kv_dequant_binary takes int32 words (..., {packed_len(d)}) "
                         f"for D = {d}, got {packed.dtype} {tuple(packed.shape)}")
    return _dequant(kv_dequant_binary, packed, scales, d, dtype)


kv_quant_int8.launches = 0
kv_dequant_int8.launches = 0
kv_quant_binary.launches = 0
kv_dequant_binary.launches = 0
