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
CUDA kernels take any row count, and the quantizers any D up to ``MAX_D``.

The quantizers are one insert kernel, which encodes and writes in one
launch: ``kv_quant_int8`` / ``kv_quant_binary`` return the codes of a
(..., D) input (mode (a)); ``kv_insert`` encodes S tokens' K and V per
slot (one at a decode step, k + 1 at the speculative verify) and writes
them into a contiguous or a paged pool from each slot's length on, as the
serving pool's ``insert_span`` and ``paged_insert_span`` did with two
quantizer launches and a torch scatter; ``kv_prefill`` encodes a prefill's
K and V into a zero-padded
cache, as ``from_prefill`` did with ``pad_time``. Each counts one launch on
its codec's ``kv_quant_<codec>.launches``.

Each wrapper runs its kernel for a CUDA tensor and its plain version
(``*_plain``: the port of repro's XLA twin, and for the inserts the encode
pair followed by the pool's torch scatter) for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. ``<wrapper>.launches`` counts
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
MAX_D = 256                           # head dims the insert kernel takes
CODECS = ("int8", "binary")


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
# the pool's writes, in torch (the inserts' plain versions; the bf16 codec
# writes through them on every device)
# ---------------------------------------------------------------------------

def leaf_names(codec: str) -> tuple[str, str, str, str]:
    """A quantized codec's leaves: (k codes, k scales, v codes, v scales)."""
    c = {"int8": "q", "binary": "p"}[codec]
    return f"k_{c}", "k_s", f"v_{c}", "v_s"


def pad_time(a: torch.Tensor, max_len: int) -> torch.Tensor:
    """Pad (B, S, ...) with zeros to (B, max_len, ...) along axis 1 (a zero
    scale dequantizes to 0, so pad rows stay inert even before the lengths
    mask them)."""
    out = a.new_zeros((a.shape[0], max_len, *a.shape[2:]))
    out[:, :a.shape[1]] = a
    return out


def write_span(leaves: dict, new: dict, lens: torch.Tensor) -> None:
    """Write S tokens per sequence, new[name] (B, S, ...), into the
    contiguous leaves[name] (B, T, ...) at positions start .. start + S - 1,
    in place, with start = lens clamped to [0, T - S], as repro's
    dynamic_update_slice clamps it (S = 1: a decode step's insert)."""
    for name, t in new.items():
        buf = leaves[name]
        s = t.shape[1]
        start = torch.clamp(lens.to(torch.int64), 0, buf.shape[1] - s)
        pos = start[:, None] + torch.arange(s, device=buf.device)[None, :]
        rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
        buf[rows, pos] = t.to(buf.dtype)


def write_paged(leaves: dict, new: dict, lens: torch.Tensor, table: torch.Tensor) -> None:
    """Write S tokens per slot, new[name] (B, S, ...), into paged leaves
    (n_blocks + 1, bs, ...), token j at (table[b, p // bs], p % bs) with
    p = lens[b] + j, in place. Free slots meet table holes (ids >=
    n_blocks), and a position at or past the table's last page meets none:
    both write to the spare block, where repro's ``mode="drop"`` drops
    them."""
    first = leaves[next(iter(new))]
    n_blocks, bs = first.shape[0] - 1, first.shape[1]
    n_pages = table.shape[1]
    s = next(iter(new.values())).shape[1]
    idx = lens.to(torch.int64)[:, None] + torch.arange(s, device=lens.device)[None, :]
    page = idx // bs
    phys = table.gather(1, torch.clamp(page, max=n_pages - 1))
    phys = torch.where(page < n_pages, phys, n_blocks)
    at = (torch.clamp(phys, max=n_blocks).to(torch.int64), idx - page * bs)
    for name, t in new.items():
        buf = leaves[name]
        buf[at] = t.to(buf.dtype)


def _encode_plain(codec: str, k: torch.Tensor, v: torch.Tensor) -> dict:
    quant = kv_quant_int8_plain if codec == "int8" else kv_quant_binary_plain
    (kc, ks), (vc, vs) = quant(k), quant(v)
    return dict(zip(leaf_names(codec), (kc, ks, vc, vs)))


def kv_insert_plain(codec: str, leaves: dict, k: torch.Tensor, v: torch.Tensor,
                    lens: torch.Tensor, *, table: torch.Tensor | None = None) -> torch.Tensor:
    """The encode pair, then the pool's torch scatter; returns lens + S."""
    new = _encode_plain(codec, k, v)
    if table is None:
        write_span(leaves, new, lens)
    else:
        write_paged(leaves, new, lens, table)
    return lens + k.shape[1]


def kv_prefill_plain(codec: str, k: torch.Tensor, v: torch.Tensor, max_len: int) -> dict:
    """The encode pair, each leaf zero-padded to max_len along time."""
    return {name: pad_time(t, max_len) for name, t in _encode_plain(codec, k, v).items()}


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types before the stream (csrc/kv_quant.cu)
_ARGTYPES = {"kv_encode": [_I, _I] + [_P] * 9 + [_I] * 8,
             "kv_dequant_int8": [_P, _P, _P, _I, _I],
             "kv_dequant_binary": [_P, _P, _P, _I, _I]}
_FNS: dict[str, object] = {}


def _entry(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from repro_torch.kernels import build
        fn = getattr(build.load("kv_quant"), f"{name}_launch")
        fn.argtypes = [*_ARGTYPES[name], _P]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(wrapper, *args, device) -> None:
    """Call the dequantizer entry point named after ``wrapper`` on the
    current stream, raise on a launch error, and count the launch."""
    from repro_torch.kernels.build import check
    name = wrapper.__name__
    check(_entry(name)(*args, torch.cuda.current_stream(device).cuda_stream), name)
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


def _code_layout(codec: str, d: int) -> tuple[int, torch.dtype]:
    """Width and dtype of a row's codes: D int8, or ceil(D / 32) words."""
    return (d, torch.int8) if codec == "int8" else (packed_len(d), torch.int32)


def _quant_wrapper(codec: str):
    return kv_quant_int8 if codec == "int8" else kv_quant_binary


def _encode(codec: str, x, xv, codes, codes_v, scales, scales_v, *, lens=None, table=None,
            lens_out=None, b: int, s: int, s_out: int, h: int, t: int) -> None:
    """Launch the insert kernel on the current stream (K and V, or x alone
    with xv None), raise on a launch error, and count one launch on the
    codec's quantizer."""
    from repro_torch.kernels.build import check
    wrapper = _quant_wrapper(codec)
    d = x.shape[-1]
    if b * s_out * h >= 2 ** 31 - 16:
        raise ValueError(f"{wrapper.__name__}: {b * s_out * h} rows exceed 31 bits")

    def ptr(a):
        return None if a is None else a.data_ptr()
    n_pages = 0 if table is None else table.shape[1]
    n_blocks = codes.shape[0] - 1 if table is not None else 0
    check(_entry("kv_encode")(
        CODECS.index(codec), int(x.dtype == torch.bfloat16), ptr(x), ptr(xv), ptr(codes),
        ptr(codes_v), ptr(scales), ptr(scales_v), ptr(lens), ptr(table), ptr(lens_out),
        b, s, s_out, h, d, t, n_pages, n_blocks,
        torch.cuda.current_stream(x.device).cuda_stream), wrapper.__name__)
    wrapper.launches += 1


def _check_kv(what: str, k: torch.Tensor, v: torch.Tensor) -> None:
    """K and V as the insert kernel takes them: (B, S, H, D) bf16 or f32,
    the same dtype, shape and device, contiguous, 1 <= D <= MAX_D."""
    if k.dtype not in _KERNEL_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"{what} takes bf16 or f32 k and v of one dtype on the card, "
                        f"got {k.dtype} and {v.dtype}")
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what} takes k and v (B, S, H, D) of one shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if v.device != k.device:
        raise ValueError(f"{what}: k on {k.device}, v on {v.device}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what} takes contiguous k and v")
    if not 1 <= k.shape[-1] <= MAX_D:
        raise ValueError(f"{what} takes head dims 1..{MAX_D}, not {k.shape[-1]}")


def kv_quant_int8(x: torch.Tensor):
    """(..., D) bf16 or f32 -> (values int8 (..., D), scales bf16 (...,))."""
    if not _on_cuda(x, "kv_quant_int8"):
        return kv_quant_int8_plain(x)
    return _quant_rows("int8", x)


def kv_quant_binary(x: torch.Tensor):
    """(..., D) bf16 or f32 -> (packed int32 (..., ceil(D / 32)), scales bf16)."""
    if not _on_cuda(x, "kv_quant_binary"):
        return kv_quant_binary_plain(x)
    return _quant_rows("binary", x)


def _quant_rows(codec: str, x: torch.Tensor):
    """Mode (a): the codes and scales of x's rows, shaped by its leading
    dims."""
    name = _quant_wrapper(codec).__name__
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} takes bf16 or f32 rows on the card, got {x.dtype}")
    d = x.shape[-1]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name} takes head dims 1..{MAX_D}, not {d}")
    x2 = _rows(x)
    n = x2.shape[0]
    width, dtype = _code_layout(codec, d)
    words = torch.empty((n, width), dtype=dtype, device=x.device)
    scales = torch.empty((n,), dtype=torch.bfloat16, device=x.device)
    if n:
        _encode(codec, x2, None, words, None, scales, None, b=n, s=1, s_out=1, h=1, t=1)
    lead = x.shape[:-1]
    return words.reshape(*lead, width), scales.reshape(lead)


def kv_insert(codec: str, leaves: dict, k: torch.Tensor, v: torch.Tensor,
              lens: torch.Tensor, *, table: torch.Tensor | None = None) -> torch.Tensor:
    """Encode S tokens' k, v (B, S, Hkv, D) per slot (S = 1 at a decode
    step, k + 1 at the speculative verify) into the ``codec`` ("int8" or
    "binary") leaves of a pool and write token j of slot b at position
    lens[b] + j, in place: contiguous leaves (B, T, Hkv, .) at min(lens,
    T - S) + j, or, with ``table`` (B, n_pages) int32, paged leaves
    (n_blocks + 1, bs, Hkv, .) at (table[b, p // bs], p % bs), a hole, a
    free slot or a position past the table's pages writing the spare block.
    lens (B,) int32. Returns lens + S, a new tensor (lens itself is not
    written)."""
    if codec not in CODECS:
        raise ValueError(f"kv_insert takes codec int8 or binary, not {codec!r}")
    if not _on_cuda(k, "kv_insert"):
        return kv_insert_plain(codec, leaves, k, v, lens, table=table)
    _check_kv("kv_insert", k, v)
    b, s, h, d = k.shape
    if s < 1:
        raise ValueError(f"kv_insert writes at least one token per slot, got S = {s}")
    names = leaf_names(codec)
    kc, ks, vc, vs = (leaves[n] for n in names)
    width, code_dtype = _code_layout(codec, d)
    nb, t = kc.shape[:2]
    codes, scales = (code_dtype, (nb, t, h, width)), (torch.bfloat16, (nb, t, h))
    want = [(names[0], kc, *codes), (names[1], ks, *scales), (names[2], vc, *codes),
            (names[3], vs, *scales), ("lens", lens, torch.int32, (b,))]
    if table is not None:
        want.append(("table", table, torch.int32, (b, table.shape[-1])))
    for what, a, dt, shape in want:
        if a.dtype != dt:
            raise TypeError(f"kv_insert takes {dt} {what}, got {a.dtype}")
        if tuple(a.shape) != shape:
            raise ValueError(f"kv_insert: {what} {tuple(a.shape)}, want {shape} for k "
                             f"{tuple(k.shape)}")
        if a.device != k.device:
            raise ValueError(f"kv_insert: {what} on {a.device}, k on {k.device}")
        if not a.is_contiguous():
            raise ValueError(f"kv_insert takes a contiguous {what}")
        if a.data_ptr() % a.element_size():
            raise ValueError(f"kv_insert: {what} is not aligned to its element size")
    if table is None and nb != b:
        raise ValueError(f"kv_insert: contiguous leaves hold {nb} slots, k {b}")
    if table is None and t < s:
        raise ValueError(f"kv_insert: a span of {s} tokens does not fit T = {t}")
    if table is not None and table.shape[-1] == 0:
        raise ValueError("kv_insert: a table of no pages")
    lens_out = torch.empty_like(lens)
    _encode(codec, k, v, kc, vc, ks, vs, lens=lens, table=table, lens_out=lens_out,
            b=b, s=s, s_out=s, h=h, t=t)
    return lens_out


def kv_prefill(codec: str, k: torch.Tensor, v: torch.Tensor, max_len: int) -> dict:
    """Encode a prefill's k, v (B, S, Hkv, D) into the ``codec`` leaves of
    a (B, max_len, Hkv, .) cache, zero codes and zero scales at positions
    >= S. Returns the four leaves by name (no len)."""
    if codec not in CODECS:
        raise ValueError(f"kv_prefill takes codec int8 or binary, not {codec!r}")
    if not _on_cuda(k, "kv_prefill"):
        return kv_prefill_plain(codec, k, v, max_len)
    _check_kv("kv_prefill", k, v)
    b, s, h, d = k.shape
    if max_len < s:
        raise ValueError(f"kv_prefill: max_len {max_len} < S = {s}")
    names = leaf_names(codec)
    width, dtype = _code_layout(codec, d)
    kc, vc = (torch.empty((b, max_len, h, width), dtype=dtype, device=k.device)
              for _ in range(2))
    ks, vs = (torch.empty((b, max_len, h), dtype=torch.bfloat16, device=k.device)
              for _ in range(2))
    if b * max_len * h:
        _encode(codec, k, v, kc, vc, ks, vs, b=b, s=s, s_out=max_len, h=h, t=max_len)
    return dict(zip(names, (kc, ks, vc, vs)))


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


def kv_dequant_int8(values: torch.Tensor, scales: torch.Tensor, *,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """values int8 (..., D), scales bf16 (...,) -> (..., D) in ``dtype``."""
    if not _on_cuda(values, "kv_dequant_int8"):
        return kv_dequant_int8_plain(values, scales, dtype)
    if values.dtype != torch.int8:
        raise TypeError(f"kv_dequant_int8 takes int8 values, got {values.dtype}")
    return _dequant(kv_dequant_int8, values, scales, values.shape[-1], dtype)


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
