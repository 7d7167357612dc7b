"""Dequant-fused decode attention over the int8 and binary KV caches.

The port of repro's ``_fused_quant_decode`` and ``paged_decode_attention``
(repro/serving/kvcache.py:282, :696) for the int8 and binary codecs:
single-step attention of q (B, S, Hq, D) over an encoded cache, in f32,
with the output in q's dtype. Every query of a slot attends to the
positions below its ``len``, or, given the speculative verify's ``q_lens``
(B, S) int32, query j of slot b to the positions below q_lens[b, j].

  contiguous  leaves (B, T, Hkv, .) and ``lens`` (B,)
  paged       leaves (n_blocks + 1, bs, Hkv, .) and ``table`` (B, n_pages)
              int32: position t of slot b lives at block table[b, t // bs],
              row t % bs; a block id past the leaf's last block (a hole)
              clamps to it, and the positions it holds lie past len.

There the dequantizing is B4b's and B4d's (``kv_dequant_int8_pallas``,
``kv_dequant_binary_pallas``), whose XLA twins XLA fuses into the scan's
block load. ``kv_decode_int8`` and ``kv_decode_binary`` run, for CUDA
tensors, the kernel in ``csrc/kv_decode.cu``: one launch per call for K and
V, every slot and head, dequantizing in registers and reading only the
positions below len (on the paged pool it walks the table itself; nothing
is gathered). The kernel holds at most ``MAX_ROWS`` query rows (G * S) per
kv head; above that the wrapper cuts the S axis into chunks of at most
MAX_ROWS // G queries, one launch each. What bounds it and how it is laid out is noted at the top of
that file. For CPU tensors they run their plain versions, the reference's
recurrence (``fused_decode_plain``); for CUDA tensors they launch the kernel
or raise. ``<wrapper>.launches`` counts kernel launches.

Where they differ: a slot with len 0 (a free slot) comes out of the kernel
as zeros, and out of the plain version, whose masked score is a finite
-1e9, as the mean of the values it visits. Nothing reads a free slot's
output. ``gather_pages`` is the paged plain version's gather, which the
pool's bf16 decode and the prefix context share.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.binarize import packed_len
from repro_torch.kernels import kv_quant as kvq
from repro_torch.kernels.flash_attention import NEG_INF

MAX_D = 128         # head dims the kernel takes
MAX_ROWS = 8        # query rows (G * S) per kv head the kernel takes
_Q_DTYPES = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# plain versions (the reference's recurrence)
# ---------------------------------------------------------------------------

def gather_pages(leaf: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """(n_blocks, bs, ...) leaf, (G, P) block ids -> (G, P * bs, ...)."""
    got = leaf[pages.to(torch.int64)]                     # (G, P, bs, ...)
    return got.reshape(got.shape[0], -1, *got.shape[3:])


def fused_decode_plain(q: torch.Tensor, leaves: dict, lens: torch.Tensor, dequant, *,
                       table: torch.Tensor | None = None, scale: float | None = None,
                       kv_block: int = 128, q_lens: torch.Tensor | None = None) -> torch.Tensor:
    """Single-query attention over encoded leaves without materializing
    them: a loop over kv blocks dequantizes one (B, kb, Hkv, D) tile per
    step (``dequant``: a dict of the block's leaves -> (k, v)) into the
    (num, den, max) recurrence. A ragged final block starts at T - kb and
    masks the columns the block before it consumed. With ``table`` the
    leaves are a paged pool: every page of every slot is gathered first
    (holes clamp to the leaf's last block). ``q_lens`` (B, S), optional:
    query j of slot b attends to the columns below q_lens[b, j] instead of
    every query below lens[b] (repro's ``valid`` with q_lens). Returns
    (B, S, Hq, D) in q's dtype."""
    if table is not None:
        last = next(iter(leaves.values())).shape[0] - 1
        pages = torch.clamp(table, 0, last)
        leaves = {name: gather_pages(leaf, pages) for name, leaf in leaves.items()}
    b, s, hq, d = q.shape
    first = next(iter(leaves.values()))
    t, hkv = first.shape[1], first.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q_lens is None:
        lim = torch.clamp(lens.to(torch.int32), max=t)[:, None, None]      # (B, 1, 1)
    else:
        lim = torch.clamp(q_lens.to(torch.int32), max=t)[:, :, None]      # (B, S, 1)
    kb = min(kv_block, t)
    qg = q.reshape(b, s, hkv, g, d).to(torch.float32)
    num = q.new_zeros((b, hkv, g, s, d), dtype=torch.float32)
    den = q.new_zeros((b, hkv, g, s), dtype=torch.float32)
    m_prev = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    for jk in range(-(-t // kb)):
        start = min(jk * kb, t - kb)
        k_blk, v_blk = dequant({name: leaf[:, start:start + kb] for name, leaf in leaves.items()})
        sij = torch.einsum("bshgd,bkhd->bhgsk", qg, k_blk.to(torch.float32)) * scale
        cols = start + torch.arange(kb, device=q.device)
        valid = (cols >= jk * kb)[None, None, :] & (cols[None, None, :] < lim)   # (B, ., kb)
        sij = torch.where(valid[:, None, None, :, :], sij, NEG_INF)
        m_cur = torch.maximum(m_prev, sij.amax(dim=-1))
        p = torch.exp(sij - m_cur[..., None])
        alpha = torch.exp(m_prev - m_cur)
        den = den * alpha + p.sum(dim=-1)
        num = num * alpha[..., None] + torch.einsum("bhgsk,bkhd->bhgsd", p,
                                                    v_blk.to(torch.float32))
        m_prev = m_cur
    den = torch.where(den == 0.0, 1.0, den)
    out = num / den[..., None]                            # (B, Hkv, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)


def _int8_block(blk: dict):
    return (kvq.kv_dequant_int8_plain(blk["k_q"], blk["k_s"], torch.float32),
            kvq.kv_dequant_int8_plain(blk["v_q"], blk["v_s"], torch.float32))


def kv_decode_int8_plain(q, k_q, k_s, v_q, v_s, lens, *, table=None, scale=None,
                         q_lens=None):
    leaves = {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}
    return fused_decode_plain(q, leaves, lens, _int8_block, table=table, scale=scale,
                              q_lens=q_lens)


def kv_decode_binary_plain(q, k_p, k_s, v_p, v_s, lens, d: int, *, table=None, scale=None,
                           q_lens=None):
    def block(blk):
        return (kvq.kv_dequant_binary_plain(blk["k_p"], blk["k_s"], d, torch.float32),
                kvq.kv_dequant_binary_plain(blk["v_p"], blk["v_s"], d, torch.float32))
    leaves = {"k_p": k_p, "k_s": k_s, "v_p": v_p, "v_s": v_s}
    return fused_decode_plain(q, leaves, lens, block, table=table, scale=scale,
                              q_lens=q_lens)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

_P, _I = ctypes.c_void_p, ctypes.c_int
_FNS: dict[str, object] = {}


def query_chunks(s: int, g: int) -> list[tuple[int, int]]:
    """The query ranges [s0, s1) of the launches for S queries at G query
    heads per kv head: chunks of at most MAX_ROWS // G queries, so each
    launch holds at most MAX_ROWS rows a block (one launch where G * S <=
    MAX_ROWS)."""
    per = MAX_ROWS // g
    return [(s0, min(s, s0 + per)) for s0 in range(0, s, per)]


def _launch(wrapper, q, codes_k, k_s, codes_v, v_s, lens, table, d: int, width: int,
            code_dtype, scale, q_lens=None) -> torch.Tensor:
    """Check what the kernel takes (raising on anything else), launch it on
    the current stream, once per chunk of at most MAX_ROWS // G queries,
    raise on a launch error, and count each launch."""
    name = wrapper.__name__
    if q.dtype not in _Q_DTYPES:
        raise TypeError(f"{name} takes bf16 or f32 q on the card, got {q.dtype}")
    want = [("k codes", codes_k, code_dtype), ("v codes", codes_v, code_dtype),
            ("k_s", k_s, torch.bfloat16), ("v_s", v_s, torch.bfloat16),
            ("lens", lens, torch.int32)]
    if table is not None:
        want.append(("table", table, torch.int32))
    if q_lens is not None:
        want.append(("q_lens", q_lens, torch.int32))
    for what, t, dt in want:
        if t.dtype != dt:
            raise TypeError(f"{name} takes {dt} {what}, got {t.dtype}")
    tensors = [q] + [t for _, t, _ in want]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: every input must be on {q.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if q.dim() != 4 or codes_k.dim() != 4:
        raise ValueError(f"{name} takes q (B, S, Hq, D) and codes (., ., Hkv, W), got "
                         f"{tuple(q.shape)} and {tuple(codes_k.shape)}")
    b, s, hq, dq = q.shape
    nb, tb, hkv, w = codes_k.shape
    if dq != d or w != width:
        raise ValueError(f"{name}: q's D {dq} and the codes' width {w} do not fit D = {d} "
                         f"(width {width})")
    if codes_v.shape != codes_k.shape or k_s.shape != codes_k.shape[:3] or \
            v_s.shape != k_s.shape or lens.shape != (b,):
        raise ValueError(f"{name}: leaves {tuple(codes_k.shape)} / {tuple(codes_v.shape)} / "
                         f"{tuple(k_s.shape)} / {tuple(v_s.shape)} and lens "
                         f"{tuple(lens.shape)} do not line up for B = {b}")
    if q_lens is not None and q_lens.shape != (b, s):
        raise ValueError(f"{name}: q_lens {tuple(q_lens.shape)}, want (B, S) = {(b, s)}")
    if table is None:
        if nb != b:
            raise ValueError(f"{name}: contiguous leaves hold {nb} slots, q {b}")
        tmax, n_pages = tb, 0
    else:
        if table.dim() != 2 or table.shape[0] != b:
            raise ValueError(f"{name}: table {tuple(table.shape)} is not (B = {b}, n_pages)")
        n_pages = table.shape[1]
        tmax = n_pages * tb
    if hq % hkv:
        raise ValueError(f"{name}: query heads {hq} not a multiple of kv heads {hkv}")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{name} takes head dims 1..{MAX_D}, not {d}")
    g = hq // hkv
    if g > MAX_ROWS:
        raise ValueError(f"{name} takes at most {MAX_ROWS} query rows a launch: G {g} query "
                         f"heads per kv head exceed it")
    if k_s.numel() >= 2 ** 31:
        raise ValueError(f"{name} indexes a leaf's rows in 31 bits, got {k_s.numel()} rows")
    if code_dtype == torch.int8 and (d % 16 or codes_k.data_ptr() % 16 or
                                     codes_v.data_ptr() % 16):
        raise ValueError(f"{name} loads int8 rows in 16-byte pieces: D must be a multiple "
                         f"of 16 and k_q, v_q 16-byte aligned (D = {d})")
    out = torch.empty_like(q)
    if b * s * hq == 0:
        return out
    fn = _FNS.get(name)
    if fn is None:
        from repro_torch.kernels import build
        fn = getattr(build.load("kv_decode"), f"{name}_launch")
        fn.argtypes = [_P] * 9 + [_I] * 10 + [ctypes.c_float, _P]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    from repro_torch.kernels.build import check
    for s0, s1 in query_chunks(s, g):
        whole = s0 == 0 and s1 == s
        qc = q if whole else q[:, s0:s1].contiguous()
        ql = q_lens if whole or q_lens is None else q_lens[:, s0:s1].contiguous()
        oc = out if whole else torch.empty_like(qc)
        check(fn(qc.data_ptr(), codes_k.data_ptr(), k_s.data_ptr(), codes_v.data_ptr(),
                 v_s.data_ptr(), lens.data_ptr(), None if ql is None else ql.data_ptr(),
                 None if table is None else table.data_ptr(), oc.data_ptr(),
                 int(q.dtype == torch.bfloat16), b, s1 - s0, hq, hkv, d, tmax, tb, n_pages,
                 nb - 1, float(scale if scale is not None else 1.0 / math.sqrt(d)),
                 torch.cuda.current_stream(q.device).cuda_stream), name)
        wrapper.launches += 1
        if not whole:
            out[:, s0:s1] = oc
    return out


def kv_decode_int8(q, k_q, k_s, v_q, v_s, lens, *, table=None, scale=None, q_lens=None):
    """Decode attention over an int8 cache: q (B, S, Hq, D); k_q, v_q int8
    and k_s, v_s bf16 leaves, contiguous or (with ``table``) paged; lens (B,)
    int32; q_lens (B, S) int32 or None. -> (B, S, Hq, D) in q's dtype."""
    if not kvq._on_cuda(q, "kv_decode_int8"):
        return kv_decode_int8_plain(q, k_q, k_s, v_q, v_s, lens, table=table, scale=scale,
                                    q_lens=q_lens)
    return _launch(kv_decode_int8, q, k_q, k_s, v_q, v_s, lens, table, q.shape[-1],
                   q.shape[-1], torch.int8, scale, q_lens)


def kv_decode_binary(q, k_p, k_s, v_p, v_s, lens, d: int, *, table=None, scale=None,
                     q_lens=None):
    """Decode attention over a binary cache: k_p, v_p int32 sign words
    (., ., Hkv, ceil(d / 32)) and bf16 scales, as for ``kv_decode_int8``."""
    if not kvq._on_cuda(q, "kv_decode_binary"):
        return kv_decode_binary_plain(q, k_p, k_s, v_p, v_s, lens, d, table=table,
                                      scale=scale, q_lens=q_lens)
    return _launch(kv_decode_binary, q, k_p, k_s, v_p, v_s, lens, table, d, packed_len(d),
                   torch.int32, scale, q_lens)


kv_decode_int8.launches = 0
kv_decode_binary.launches = 0
