"""Shared LM machinery for dense GQA transformers (port of the GQA parts of
repro/models/lm_common.py).

Precision policy (the paper's technique as a config): every FFN goes
through ``ffn_init`` / ``ffn_apply``, a float SwiGLU or the BEANNA binary
MLP (two binary denses over sign(x)) depending on the block's flag.

repro groups identical blocks into segments and scans over their stacked
weights; the port keeps one param dict and one cache dict per layer and
loops over them. ``build_segments`` stays, to map repro's stacked params
(models/convert.py).

Training (``segments_apply``, ``block_apply``, ``softmax_xent``) reads each
binary FFN's latent weight through the straight-through estimator, since
the trainer's params hold no packed copy; serving reads the packed copy
that ``ffn_init`` / ``pack_tree`` add.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binary_dense import binary_dense_apply_any, binary_dense_init, with_packed
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers as nn
from repro_torch.serving import kvcache as kvc


def padded_vocab(v: int) -> int:
    """Embedding tables are padded to a multiple of 256; padded logits are
    masked to -1e9."""
    return -(-v // 256) * 256


def mask_pad_logits(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    vp = logits.shape[-1]
    if vp == vocab:
        return logits
    pad = torch.arange(vp, device=logits.device) >= vocab
    return logits.masked_fill(pad, -1e9)


def cdt(cfg: ModelConfig) -> torch.dtype:   # compute dtype
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ModelConfig) -> torch.dtype:   # param dtype
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# hybrid FFN
# ---------------------------------------------------------------------------

def ffn_init(cfg: ModelConfig, *, binary: bool, generator, device,
             packed: bool = True) -> dict:
    """Binary FFNs are identified structurally (keys 'bin_in' / 'bin_out').
    ``packed``: add the serving copy of the sign words (the trainer, whose
    steps would leave it stale, holds latents only)."""
    kw = dict(generator=generator, device=device, dtype=pdt(cfg))
    if binary:
        add = with_packed if packed else (lambda p: p)
        return {"bin_in": add(binary_dense_init(cfg.d_model, cfg.d_ff, **kw)),
                "bin_out": add(binary_dense_init(cfg.d_ff, cfg.d_model, **kw))}
    return nn.swiglu_init(cfg.d_model, cfg.d_ff, **kw)


def ffn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "bin_in" in p:
        # the normed residual feeds sign() inside the binary dense; it reads
        # the packed copy where the tree holds one (serving), else the
        # latent through the STE (training)
        mode = cfg.policy.binary_mode
        h = binary_dense_apply_any(p["bin_in"], x, mode=mode)
        return binary_dense_apply_any(p["bin_out"], h, mode=mode).to(x.dtype)
    # binary_impl matters only where these denses are the self-draft's
    # packed ones (serving/spec.binarize_draft_params)
    return nn.swiglu_apply(p, x, compute_dtype=cdt(cfg), binary_impl=cfg.spec_draft_impl)


def _dense(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return nn.dense_apply(p, x, compute_dtype=cdt(cfg), binary_impl=cfg.spec_draft_impl)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def gqa_init(cfg: ModelConfig, *, generator, device) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.kv_head_dim()
    kw = dict(generator=generator, device=device, dtype=pdt(cfg))
    p = {"wq": nn.dense_init(d, hq * dh, bias=cfg.qkv_bias, **kw),
         "wk": nn.dense_init(d, hkv * dh, bias=cfg.qkv_bias, **kw),
         "wv": nn.dense_init(d, hkv * dh, bias=cfg.qkv_bias, **kw),
         "wo": nn.dense_init(hq * dh, d, **kw)}
    if cfg.qk_norm:
        p["q_norm"] = nn.rmsnorm_init(dh, device=device)
        p["k_norm"] = nn.rmsnorm_init(dh, device=device)
    return p


def gqa_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    dh = cfg.kv_head_dim()
    q = _dense(p["wq"], x, cfg).reshape(b, s, cfg.n_heads, dh)
    k = _dense(p["wk"], x, cfg).reshape(b, s, cfg.n_kv_heads, dh)
    v = _dense(p["wv"], x, cfg).reshape(b, s, cfg.n_kv_heads, dh)
    if cfg.qk_norm:
        q = nn.rmsnorm_apply(p["q_norm"], q)
        k = nn.rmsnorm_apply(p["k_norm"], k)
    if cfg.use_rope:
        q = nn.apply_rope(q, positions, base=cfg.rope_base)
        k = nn.apply_rope(k, positions, base=cfg.rope_base)
    return q, k, v


def gqa_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions):
    """Causal self attention over the full sequence, no cache."""
    q, k, v = gqa_qkv(p, x, cfg, positions)
    o = attn_lib.prefill_attention(q, k, v, chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    return _dense(p["wo"], o.reshape(*x.shape[:2], -1), cfg)


def gqa_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """One-token decode against the cache; x (B, 1, d). The ``cfg.kv_cache``
    codec owns the layout and, for int8 / binary, the dequant-fused attend
    (serving/kvcache.py). A paged cache (one with a "table" leaf) inserts
    and attends through its block table."""
    positions = cache["len"][:, None]                     # (B, 1)
    q, k, v = gqa_qkv(p, x, cfg, positions)
    codec = kvc.get_codec(cfg.kv_cache)
    if "table" in cache:
        cache = kvc.paged_insert_span(cache, k, v, codec)
        o = kvc.paged_decode_attention(q, cache, codec)
    else:
        cache = codec.insert_span(cache, k, v)
        o = codec.decode_attention(q, cache, impl=cfg.attn_impl)
    return _dense(p["wo"], o.reshape(*x.shape[:2], -1), cfg), cache


def gqa_verify(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Multi-token decode against the cache: the speculative verify step.
    x (B, S, d) carries a draft wave (S = k + 1 tokens); their exact K/V go
    to positions len .. len + S - 1 (over the draft's approximate ones,
    which no read saw: every read masks by len), and query j attends to the
    columns below len + j + 1 through the decode attend with per-query
    lengths, so one pass scores every draft position. Both pool layouts and
    every codec; ``len`` advances by S (the engine rolls it back to len +
    accepted)."""
    s = x.shape[1]
    base = cache["len"]                                             # (B,) pre-insert
    positions = base[:, None] + torch.arange(s, device=x.device)[None, :]
    q, k, v = gqa_qkv(p, x, cfg, positions)
    q_lens = (positions + 1).to(torch.int32)    # taken before the insert moves len
    codec = kvc.get_codec(cfg.kv_cache)
    if "table" in cache:
        cache = kvc.paged_insert_span(cache, k, v, codec)
        o = kvc.paged_decode_attention(q, cache, codec, q_lens=q_lens)
    else:
        cache = codec.insert_span(cache, k, v)
        o = codec.decode_attention(q, cache, q_lens=q_lens)
    return _dense(p["wo"], o.reshape(*x.shape[:2], -1), cfg), cache


# ---------------------------------------------------------------------------
# decoder block (pre-norm residual)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class BlockSig:
    attn: str        # "gqa" | "mla"
    ffn: str         # "float" | "binary"
    moe: bool = False


def block_sig(cfg: ModelConfig, idx: int) -> BlockSig:
    binary = cfg.policy.block_is_binary(idx, cfg.n_layers)
    attn = "mla" if cfg.use_mla else "gqa"
    moe = cfg.family == "moe" and idx >= cfg.first_dense_layers
    return BlockSig(attn, "binary" if binary else "float", moe)


def _check_sig(sig: BlockSig) -> None:
    if sig.attn != "gqa" or sig.moe:
        raise NotImplementedError(f"block {sig}: MLA and MoE blocks are ROADMAP A8")


def block_init(cfg: ModelConfig, sig: BlockSig, *, generator, device,
               packed: bool = True) -> dict:
    _check_sig(sig)
    kw = dict(generator=generator, device=device)
    return {"attn": gqa_init(cfg, **kw),
            "ffn": ffn_init(cfg, binary=sig.ffn == "binary", packed=packed, **kw),
            "ln1": nn.rmsnorm_init(cfg.d_model, device=device),
            "ln2": nn.rmsnorm_init(cfg.d_model, device=device)}


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, sig: BlockSig, *,
                positions) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward of one block -> (x, aux); aux is the MoE balance
    loss, 0.0 for a dense block (repro/models/lm_common.py:335)."""
    _check_sig(sig)
    h = nn.rmsnorm_apply(p["ln1"], x)
    x = x + gqa_apply(p["attn"], h, cfg, positions=positions)
    h = nn.rmsnorm_apply(p["ln2"], x)
    return x + ffn_apply(p["ffn"], h, cfg), x.new_zeros((), dtype=torch.float32)


def block_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, sig: BlockSig, *,
                  positions, max_len: int, seq_lens=None, ctx=None, ctx_len=None):
    """Full-sequence forward that also emits this block's decode cache.
    seq_lens (B,) masks keys past each row's true length in a right-padded
    batch (real rows see the same keys either way: causality hides the
    trailing pads).

    ctx / ctx_len carry a cached prefix for a suffix prefill (the radix
    prefix cache): ctx is this block's {"k", "v"} (B, P, Hkv, D) gathered
    from the paged pool, ctx_len (B,) its valid lengths, and ``positions``
    the suffix tokens' absolute (B, S) positions. That prefill attends with
    the plain prefix attention, not the flash kernel, as in repro.

    K/V are encoded into the ``cfg.kv_cache`` codec after attention, which
    uses them unquantized: prefill logits are the same under every codec."""
    _check_sig(sig)
    b, s, _ = x.shape
    h = nn.rmsnorm_apply(p["ln1"], x)
    q, k, v = gqa_qkv(p["attn"], h, cfg, positions)
    if ctx is not None:
        o = attn_lib.prefix_prefill_attention(q, ctx["k"], ctx["v"], ctx_len, k, v,
                                              kv_len=seq_lens)
    else:
        o = attn_lib.prefill_attention(q, k, v, chunk=cfg.attn_chunk, kv_len=seq_lens,
                                       impl=cfg.attn_impl)
    a = _dense(p["attn"]["wo"], o.reshape(b, s, -1), cfg)
    cache = kvc.get_codec(cfg.kv_cache).from_prefill(k, v, max_len)
    x = x + a
    h = nn.rmsnorm_apply(p["ln2"], x)
    return x + ffn_apply(p["ffn"], h, cfg), cache


def block_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, sig: BlockSig,
                 cache: dict):
    _check_sig(sig)
    h = nn.rmsnorm_apply(p["ln1"], x)
    a, cache = gqa_decode(p["attn"], h, cfg, cache)
    x = x + a
    h = nn.rmsnorm_apply(p["ln2"], x)
    return x + ffn_apply(p["ffn"], h, cfg), cache


def block_verify(p: dict, x: torch.Tensor, cfg: ModelConfig, sig: BlockSig,
                 cache: dict):
    """block_decode for an S-token verify wave (GQA only: MLA's absorbed
    decode has no multi-token form, as in repro)."""
    if sig.attn == "mla":
        raise ValueError("speculative verify requires GQA attention blocks; MLA "
                         "families decode one token at a time")
    _check_sig(sig)
    h = nn.rmsnorm_apply(p["ln1"], x)
    a, cache = gqa_verify(p["attn"], h, cfg, cache)
    x = x + a
    h = nn.rmsnorm_apply(p["ln2"], x)
    return x + ffn_apply(p["ffn"], h, cfg), cache


# ---------------------------------------------------------------------------
# the layer loop (repro: lax.scan over segments of stacked layers)
# ---------------------------------------------------------------------------

def build_segments(cfg: ModelConfig) -> list[tuple[BlockSig, int, int]]:
    """[(sig, start, count)]: runs of consecutive blocks with one structure,
    covering blocks 0..n_layers-1 — repro's segments, whose params it
    stacks as ``seg{i}``."""
    segs = []
    for i in range(cfg.n_layers):
        sig = block_sig(cfg, i)
        if segs and segs[-1][0] == sig:
            segs[-1] = (sig, segs[-1][1], segs[-1][2] + 1)
        else:
            segs.append((sig, i, 1))
    return segs


REMAT_MODES = ("none", "block", "full", "dots")


def _maybe_remat(fn, cfg: ModelConfig):
    """repro's _maybe_remat (lm_common.py:517-523): "none" keeps every
    activation; "block" and "full" keep each block's input and recompute
    the block in the backward (torch.utils.checkpoint, non-reentrant: on
    the card the recompute launches the block's kernels again). JAX's
    "dots" policy (keep the products' outputs) is not mapped."""
    if cfg.remat == "none":
        return fn
    if cfg.remat in ("block", "full"):
        from torch.utils.checkpoint import checkpoint
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    if cfg.remat == "dots":
        raise NotImplementedError('remat="dots" (save the products\' outputs) has no '
                                  'counterpart here; use "block" or "none"')
    raise ValueError(f"unknown remat {cfg.remat!r}; known: {REMAT_MODES}")


def segments_apply(blocks: list, x: torch.Tensor, cfg: ModelConfig, *,
                   positions) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward: every block in turn under ``cfg.remat`` ->
    (x, total aux)."""
    total_aux = x.new_zeros((), dtype=torch.float32)
    for i, p in enumerate(blocks):
        one = _maybe_remat(lambda x, p, sig=block_sig(cfg, i): block_apply(
            p, x, cfg, sig, positions=positions), cfg)
        x, aux = one(x, p)
        total_aux = total_aux + aux
    return x, total_aux


def segments_prefill(blocks: list, x: torch.Tensor, cfg: ModelConfig, *,
                     positions, max_len: int, seq_lens=None, ctx=None, ctx_len=None):
    """Every block in turn; returns (x, one cache per layer). ctx, for a
    suffix prefill, is one cached-prefix {"k", "v"} per layer."""
    caches = []
    for i, p in enumerate(blocks):
        x, c = block_prefill(p, x, cfg, block_sig(cfg, i), positions=positions,
                             max_len=max_len, seq_lens=seq_lens,
                             ctx=None if ctx is None else ctx[i], ctx_len=ctx_len)
        caches.append(c)
    return x, caches


def segments_decode(blocks: list, x: torch.Tensor, cfg: ModelConfig, caches: list):
    """Every block in turn against its cache (updated in place)."""
    for i, (p, c) in enumerate(zip(blocks, caches)):
        x, caches[i] = block_decode(p, x, cfg, block_sig(cfg, i), c)
    return x, caches


def segments_verify(blocks: list, x: torch.Tensor, cfg: ModelConfig, caches: list):
    """segments_decode for an S-token verify wave: block_verify per block,
    each cache updated in place."""
    for i, (p, c) in enumerate(zip(blocks, caches)):
        x, caches[i] = block_verify(p, x, cfg, block_sig(cfg, i), c)
    return x, caches


def set_cache_lengths(caches: list, seq_lens) -> list:
    return kvc.set_cache_lengths(caches, seq_lens)


def cache_insert_slots(pool: list, new: list, slots) -> list:
    return kvc.cache_insert_slots(pool, new, slots)


def init_segment_caches(cfg: ModelConfig, batch: int, max_len: int,
                        dtype=torch.bfloat16, *, device) -> list:
    """Empty decode caches, one per layer, in the ``cfg.kv_cache`` codec's
    layout."""
    codec = kvc.get_codec(cfg.kv_cache)
    return [codec.init(batch, max_len, cfg.n_kv_heads, cfg.kv_head_dim(), dtype,
                       device=device) for _ in range(cfg.n_layers)]


def init_paged_segment_caches(cfg: ModelConfig, n_blocks: int, block_size: int,
                              max_batch: int, n_pages: int, dtype=torch.bfloat16, *,
                              device) -> list:
    """The paged decode pool, one per layer: a shared (n_blocks, block_size,
    ...) block pool in the ``cfg.kv_cache`` codec's layout plus the slots'
    block tables (serving/kvcache.init_paged)."""
    codec = kvc.get_codec(cfg.kv_cache)
    return [kvc.init_paged(codec, n_blocks, block_size, cfg.n_kv_heads, cfg.kv_head_dim(),
                           max_batch, n_pages, dtype, device=device)
            for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with z-loss (repro/models/lm_common.py:675):
    logits (..., V) taken in f32, labels (...) integer."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    ce = lse - ll
    if z_loss:
        ce = ce + z_loss * lse ** 2
    return ce.mean()
