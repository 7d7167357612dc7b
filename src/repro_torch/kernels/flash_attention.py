"""Online-softmax (flash) attention, forward.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_call``
(B3, reached through ``flash_attention_pallas``) with the CUDA kernel in
``csrc/flash_attention.cu``; what bounds it on an H100 and how it is laid
out is noted at the top of that file. At the serving shapes it is bound by
bytes. bf16 inputs, which every serving path sends, run on the tensor
cores (FA2-style ``mma.sync`` m16n8k16, each warp 16 query rows with S and
O in registers, K / V tiles double-buffered by ``cp.async``); f32 inputs
run the CUDA-core design, which holds f32's tolerance.

Shapes follow the JAX package: q and k (B, S, Hq, D) / (B, T, Hkv, D), v
(B, T, Hkv, Dv), output (B, S, Hq, Dv); Dv differs from D in MLA's prefill
(q and k are [nope | rope]: (D, Dv) = (24, 16) at the smoke configs, (96,
64) for minicpm3-4b, (192, 128) for deepseek-v2). GQA groups G = Hq // Hkv (query head h reads kv head h // G), causal
masking against absolute query positions ``q_offset + s``, ``kv_len`` (B,)
or a scalar masking keys at and past it (clamped to T), masked scores at
the finite -1e9, f32 running statistics, output in v's dtype.

``flash_attention`` runs the kernel for CUDA tensors and the plain
version, ``flash_attention_plain`` (a port of ``blockwise_attention_xla``),
for CPU tensors; for CUDA tensors it launches the kernel or raises.
``flash_attention.launches`` counts kernel launches.

It is differentiable: a ``torch.autograd.Function`` whose forward is the
kernel (or, on the CPU, the plain version) and whose backward recomputes
the attention through ``flash_attention_plain`` under autograd and pulls
the output's gradient back through it, as the TPU path does through its
blockwise twin (repro/kernels/flash_attention.py:165-191: a pallas_call
has no autodiff rule). The kernel writes its output through a raw
pointer, so without the Function the output would carry no ``grad_fn``
and wq, wk and wv would get no gradient through attention, silently.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

NEG_INF = -1e9   # finite, so a fully masked row averages instead of NaN

# the (D, Dv) pairs the CUDA kernel is built for: the GQA head widths, then MLA's
HEAD_DIMS = ((16, 16), (64, 64), (80, 80), (128, 128), (24, 16), (96, 64), (192, 128))
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _kv_len(kv_len, b: int, t: int, device) -> torch.Tensor:
    """kv_len (None, scalar or (B,)) -> (B,) int32 clamped to t."""
    if kv_len is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    kvl = torch.as_tensor(kv_len, dtype=torch.int32, device=device).reshape(-1)
    return torch.clamp(kvl.expand(b), max=t).to(torch.int32).contiguous()


def _pad_dim1(x: torch.Tensor, n: int) -> torch.Tensor:
    if n == x.shape[1]:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, n - x.shape[1]]
    return F.pad(x, pad)


def flash_attention_plain(q, k, v, *, causal: bool, kv_len=None,
                          scale: float | None = None, q_offset: int = 0,
                          q_block: int = 512, kv_block: int = 512):
    """The same online-softmax recurrence in plain torch, a loop over query
    blocks with an inner loop over kv blocks, all in f32 (port of
    repro/kernels/flash_attention.py::blockwise_attention_xla)."""
    b, s, hq, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qb, kb = min(q_block, s), min(kv_block, t)
    sp, tp = _round_up(s, qb), _round_up(t, kb)
    nq, nk = sp // qb, tp // kb
    kvlen = _kv_len(kv_len, b, t, q.device)

    qf = _pad_dim1(q, sp).reshape(b, nq, qb, hkv, g, d).float()
    kf = _pad_dim1(k, tp).reshape(b, nk, kb, hkv, d).float()
    vf = _pad_dim1(v, tp).reshape(b, nk, kb, hkv, dv).float()
    ar_q = torch.arange(qb, device=q.device)
    ar_k = torch.arange(kb, device=q.device)

    outs = []
    for iq in range(nq):
        qi = qf[:, iq]
        num = q.new_zeros((b, hkv, g, qb, dv), dtype=torch.float32)
        den = q.new_zeros((b, hkv, g, qb), dtype=torch.float32)
        m_prev = torch.full((b, hkv, g, qb), NEG_INF, dtype=torch.float32,
                            device=q.device)
        for jk in range(nk):
            sij = torch.einsum("bqhgd,bkhd->bhgqk", qi, kf[:, jk]) * scale
            cols = jk * kb + ar_k
            valid = (cols[None, :] < kvlen[:, None])[:, None, None, None, :]
            if causal:
                rows = q_offset + iq * qb + ar_q
                valid = valid & (rows[:, None] >= cols[None, :])
            sij = torch.where(valid, sij, NEG_INF)
            m_cur = torch.maximum(m_prev, sij.amax(dim=-1))
            p = torch.exp(sij - m_cur[..., None])
            alpha = torch.exp(m_prev - m_cur)
            den = den * alpha + p.sum(dim=-1)
            num = num * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vf[:, jk])
            m_prev = m_cur
        den = torch.where(den == 0.0, 1.0, den)
        oi = num / den[..., None]                           # (B, Hk, G, qb, Dv)
        outs.append(oi.permute(0, 3, 1, 2, 4).reshape(b, qb, hq, dv))
    return torch.cat(outs, dim=1)[:, :s].to(v.dtype)


def _lib():
    from repro_torch.kernels import build
    fn = build.load("flash_attention").flash_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class _FlashAttention(torch.autograd.Function):
    """The forward on the card (or its plain version on the CPU); the
    backward, repro's recompute: autograd through flash_attention_plain at
    the blocks the reference's backward uses (its bq, bk of 128)."""

    @staticmethod
    def forward(ctx, q, k, v, kvlen, causal, scale, q_offset):
        ctx.save_for_backward(q, k, v, kvlen)
        ctx.opts = dict(causal=causal, scale=scale, q_offset=q_offset)
        if q.device.type == "cpu":
            return flash_attention_plain(q, k, v, kv_len=kvlen, **ctx.opts)
        return _launch(q, k, v, kvlen, causal, scale, q_offset)

    @staticmethod
    def backward(ctx, g):
        q, k, v, kvlen = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = flash_attention_plain(*qkv, kv_len=kvlen, q_block=128, kv_block=128,
                                        **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, qkv, g.to(v.dtype))
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool, kv_len=None,
                    scale: float | None = None, q_offset: int = 0):
    """Online-softmax attention -> (B, S, Hq, Dv) in v's dtype;
    differentiable in q, k and v."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"query heads {hq} not a multiple of kv heads {hkv}")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    kvlen = _kv_len(kv_len, b, t, q.device)
    return _FlashAttention.apply(q, k, v, kvlen, causal, scale, q_offset)


def _launch(q, k, v, kvlen, causal: bool, scale: float, q_offset: int):
    """One launch of the kernel on CUDA tensors, after checking what it
    takes."""
    b, s, hq, d = q.shape
    t, hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if (d, dv) not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel is built for head dims (D, Dv) in "
                         f"{HEAD_DIMS}, not {(d, dv)}")
    if not (q.dtype == k.dtype == v.dtype and q.dtype in _DTYPE_CODES):
        raise TypeError(f"the CUDA kernel takes one of {list(_DTYPE_CODES)} "
                        f"for q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape[0] != b or k.shape[3] != d or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_attention stages 16-byte chunks: q, k and v must be "
                         "16-byte aligned")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    out = torch.empty((b, s, hq, dv), dtype=v.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    from repro_torch.kernels.build import check
    check(_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kvlen.data_ptr(),
                 out.data_ptr(), b, s, t, hq, hkv, d, dv, float(scale),
                 int(bool(causal)), int(q_offset), _DTYPE_CODES[q.dtype],
                 stream), "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
