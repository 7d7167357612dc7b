"""Attention and the bf16 KV cache (port of repro/nn/attention.py: GQA,
MLA and cross-attention).

Every model calls one entrypoint per shape family, and the lowering is
resolved per call (``resolve_attn_impl``):

  prefill_attention   full-sequence self attention, causal by default,
                      optional kv_len for right-padded batches
  decode_attention    single-query attend over a preallocated cache
  cross_attention     non-causal attention over a context (whisper's
                      encoder self-attention and cross-attention,
                      llama-vision's gated cross blocks), optional kv_len
  prefix_prefill_attention
                      suffix prefill against a cached prefix (the radix
                      prefix cache's admissions; no kernel, as in repro)
  mla_prefill_attention
                      MLA's expanded-KV prefill: prefill_attention over q
                      and k = [nope | rope] (D = dn + dr) and v (Dv)
  mla_absorbed_decode MLA's matrix-absorbed decode over the compressed
                      cache (plain torch, as repro keeps it in XLA)

Backends:

  "ref"     score-materializing reference: dot_attention, or a loop over
            query chunks (chunked_causal_attention) for long causal prefill
  "flash"   kernels/flash_attention.flash_attention: the CUDA kernel for
            CUDA tensors, its plain blockwise version for CPU tensors
  "auto"    prefill and cross: flash for a CUDA tensor and ref on the CPU,
            as repro picks its Pallas kernel off CPU and xla_ref on it; decode: ref
            everywhere (one query against a cache has no score blowup, and
            repro has no decode kernel)

Shapes: q (B, S, Hq, D), k (B, T, Hkv, D), v (B, T, Hkv, Dv); GQA groups
G = Hq // Hkv.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.kv_quant import write_span

NEG_INF = -1e9   # finite, as in repro: a fully masked row stays finite

ATTN_IMPLS = ("auto", "ref", "flash")

KV_CACHE_IMPLS = ("auto", "bf16", "int8", "binary")


def resolve_kv_cache(impl: str = "auto") -> str:
    """``ModelConfig.kv_cache`` -> codec name ("auto" is bf16, as in repro);
    the codecs live in serving/kvcache.py."""
    if impl not in KV_CACHE_IMPLS:
        raise ValueError(f"unknown kv cache codec {impl!r}; known: {KV_CACHE_IMPLS}")
    return "bf16" if impl == "auto" else impl


def resolve_attn_impl(impl: str = "auto", *, family: str = "prefill",
                      device: torch.device) -> str:
    """family in {prefill, decode, cross} -> concrete impl for this call."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn impl {impl!r}; known: {ATTN_IMPLS}")
    if impl != "auto":
        return impl
    if family == "decode":
        return "ref"
    return "flash" if device.type == "cuda" else "ref"


def _kv_mask(kv_len, b: int, t: int, device) -> torch.Tensor:
    kvl = torch.as_tensor(kv_len, dtype=torch.int32, device=device).reshape(-1)
    kvl = kvl.expand(b)
    return (torch.arange(t, device=device)[None, :] < kvl[:, None]).reshape(b, 1, 1, 1, t)


def dot_attention(q, k, v, *, causal: bool, q_offset: int = 0, kv_len=None,
                  scale: float | None = None):
    """Unchunked grouped attention; scores and softmax in f32, the weighted
    sum in v's dtype (as repro's einsum does)."""
    b, s, hq, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hkv, g, d)
    scores = torch.einsum("bshgd,bthd->bhgst", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if kv_len is not None:
        scores = torch.where(_kv_mask(kv_len, b, t, q.device), scores, NEG_INF)
    if causal:
        qpos = torch.arange(s, device=q.device) + q_offset
        kpos = torch.arange(t, device=q.device)
        scores = torch.where(qpos[:, None] >= kpos[None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", w.to(v.dtype), v)
    return out.reshape(b, s, hq, v.shape[-1])


def chunked_causal_attention(q, k, v, *, chunk: int = 1024,
                             scale: float | None = None, kv_len=None):
    """Causal self-attention over query chunks (bounded score memory). A
    ragged last chunk is padded; its pad rows are sliced off."""
    b, s, hq, d = q.shape
    if s <= chunk:
        return dot_attention(q, k, v, causal=True, scale=scale, kv_len=kv_len)
    n = -(-s // chunk)
    qp = torch.cat([q, q.new_zeros((b, n * chunk - s, hq, d))], dim=1)
    outs = [dot_attention(qp[:, i * chunk:(i + 1) * chunk], k, v, causal=True,
                          q_offset=i * chunk, scale=scale, kv_len=kv_len)
            for i in range(n)]
    return torch.cat(outs, dim=1)[:, :s]


def prefill_attention(q, k, v, *, causal: bool = True, kv_len=None,
                      chunk: int = 1024, scale: float | None = None,
                      impl: str = "auto"):
    """Full-sequence attention; kv_len masks keys past each row's true
    length in a right-padded batch."""
    impl = resolve_attn_impl(impl, family="prefill", device=q.device)
    if impl == "ref":
        if causal:
            return chunked_causal_attention(q, k, v, chunk=chunk, scale=scale,
                                            kv_len=kv_len)
        return dot_attention(q, k, v, causal=False, kv_len=kv_len, scale=scale)
    return flash_attention(q, k, v, causal=causal, kv_len=kv_len, scale=scale)


def decode_attention(q, k, v, *, kv_len, scale: float | None = None,
                     impl: str = "auto"):
    """Single-query attend over a preallocated cache; kv_len is the valid
    cache length per sequence."""
    impl = resolve_attn_impl(impl, family="decode", device=q.device)
    if impl == "ref":
        return dot_attention(q, k, v, causal=False, kv_len=kv_len, scale=scale)
    return flash_attention(q, k, v, causal=False, kv_len=kv_len, scale=scale)


def cross_attention(q, k, v, *, kv_len=None, impl: str = "auto"):
    """Full (non-causal) attention of q (B, S, Hq, D) over a context k, v
    (B, T, Hkv, D), S and T free; kv_len (B,) masks context past each row's
    length."""
    impl = resolve_attn_impl(impl, family="cross", device=q.device)
    return prefill_attention(q, k, v, causal=False, kv_len=kv_len, impl=impl)


def prefix_prefill_attention(q, k_ctx, v_ctx, ctx_len, k, v, *, kv_len=None,
                             scale: float | None = None):
    """Suffix prefill continuing a cached prefix: one softmax over [prefix
    context ++ suffix]. Each query sees every valid context position
    (columns < ctx_len[b]) and the suffix causally — the keys the same
    tokens see in a full prefill. q carries absolute positions (RoPE at
    ctx_len[b] + j); the context comes gathered (and dequantized) from the
    paged pool.

    q (B, S, Hq, D); k_ctx, v_ctx (B, P, Hkv, D); ctx_len (B,) (0 = no
    cached prefix); k, v (B, S, Hkv, D); kv_len (B,) true suffix lengths of
    a right-padded batch. Scores and softmax in f32, each weighted sum in
    its values' dtype, their sum in f32; returns q's dtype."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    p = k_ctx.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, s, hkv, hq // hkv, d).to(torch.float32)
    s_ctx = torch.einsum("bshgd,bthd->bhgst", qg, k_ctx.to(torch.float32)) * scale
    s_suf = torch.einsum("bshgd,bthd->bhgst", qg, k.to(torch.float32)) * scale
    s_ctx = torch.where(_kv_mask(ctx_len, b, p, q.device), s_ctx, NEG_INF)
    pos = torch.arange(s, device=q.device)
    mask_suf = (pos[:, None] >= pos[None, :])[None, None, None]
    if kv_len is not None:
        mask_suf = mask_suf & _kv_mask(kv_len, b, s, q.device)
    s_suf = torch.where(mask_suf, s_suf, NEG_INF)
    w = torch.softmax(torch.cat([s_ctx, s_suf], dim=-1), dim=-1)
    out = (torch.einsum("bhgst,bthd->bshgd", w[..., :p].to(v_ctx.dtype), v_ctx)
           .to(torch.float32)
           + torch.einsum("bhgst,bthd->bshgd", w[..., p:].to(v.dtype), v).to(torch.float32))
    return out.reshape(b, s, hq, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention: DeepSeek-V2/V3, MiniCPM3)
# ---------------------------------------------------------------------------

def mla_prefill_attention(q_nope, q_rope, k_nope, k_rope, v, *, chunk: int = 1024,
                          kv_len=None, impl: str = "auto"):
    """Expanded-KV MLA prefill. q_nope, k_nope (B, S, H, dn); q_rope, k_rope
    (B, S, H, dr), k_rope broadcast from its one shared rope head; v (B, S,
    H, dv) -> (B, S, H, dv). On a card the flash kernel takes (dn + dr,
    dv)."""
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope], dim=-1)
    return prefill_attention(q, k, v.contiguous(), causal=True, chunk=chunk,
                             scale=1.0 / math.sqrt(q.shape[-1]), kv_len=kv_len, impl=impl)


def mla_absorbed_decode(q_abs, q_rope, c_cache, kr_cache, kv_len, *, sm_scale: float):
    """Matrix-absorbed MLA decode against the compressed cache: q_abs (B, 1,
    H, c) is q_nope already through W_uk, q_rope (B, 1, H, dr), c_cache (B,
    T, c), kr_cache (B, T, dr), kv_len (B,) -> (B, 1, H, c), attention over
    the compressed values. Scores in f32 (repro's preferred_element_type),
    masked at the finite -1e9; the weighted sum in the cache's dtype. No
    kernel: the compressed cache is the point, and the (B, H, 1, T) scores
    are decode-sized."""
    f32 = torch.float32
    s_nope = torch.einsum("bshc,btc->bhst", q_abs.to(f32), c_cache.to(f32))
    s_rope = torch.einsum("bshr,btr->bhst", q_rope.to(f32), kr_cache.to(f32))
    scores = (s_nope + s_rope) * sm_scale
    t = c_cache.shape[1]
    valid = (torch.arange(t, device=c_cache.device)[None, :] < kv_len[:, None])
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,btc->bshc", w.to(c_cache.dtype), c_cache)


# ---------------------------------------------------------------------------
# KV cache (the bf16 layout; serving/kvcache.py wraps it)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, *, device) -> dict:
    return {"k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype, device=device),
            "len": torch.zeros((batch,), dtype=torch.int32, device=device)}


def cache_update_decode(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor) -> dict:
    """Insert one token per sequence, k_new / v_new (B, 1, Hkv, D), at
    position cache["len"] and advance ``len`` by one, all in place (repro
    returns a new cache; the port's caches are written where they lie)."""
    write_span(cache, {"k": k_new, "v": v_new}, cache["len"])
    cache["len"].add_(1)
    return cache
