"""Decoder LM for the dense GQA archs (port of repro/models/transformer.py,
serving half: init, prefill, chunked and interleaved (sliced) prefill,
suffix prefill against a cached prefix, decode, the speculative verify,
contiguous and paged caches)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm_common as lc
from repro_torch.nn import layers as nn


def lm_init(cfg: ModelConfig, seed: int, *, device="cuda") -> dict:
    """Random params on ``device`` from a seeded torch.Generator, with
    repro's init distributions (not its numbers: the tests carry repro's
    own params over with models/convert.py)."""
    device = resolve_device(device)
    if cfg.use_mtp:
        raise NotImplementedError("multi-token prediction heads are ROADMAP A8")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=device)
    vp = lc.padded_vocab(cfg.vocab)
    p = {"embed": nn.embedding_init(vp, cfg.d_model, dtype=lc.pdt(cfg), **kw),
         "blocks": [lc.block_init(cfg, lc.block_sig(cfg, i), **kw)
                    for i in range(cfg.n_layers)],
         "ln_f": nn.rmsnorm_init(cfg.d_model, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = nn.dense_init(cfg.d_model, vp, dtype=lc.pdt(cfg), **kw)
    return p


def _logits(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = nn.rmsnorm_apply(p["ln_f"], x)
    if cfg.tie_embeddings:
        logits = nn.embedding_logits(p["embed"], x, compute_dtype=lc.cdt(cfg))
    else:
        logits = nn.dense_apply(p["head"], x, compute_dtype=lc.cdt(cfg))
    return lc.mask_pad_logits(logits, cfg.vocab)


def _embed(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return nn.embedding_lookup(p["embed"], tokens, compute_dtype=lc.cdt(cfg))


def lm_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
               max_len: int | None = None, seq_lens=None):
    """Full-sequence forward -> (last-token logits (B, Vp), caches).

    seq_lens (B,) gives each row's true length in a right-padded batch:
    logits are taken at position seq_lens - 1 and cache lengths are reset,
    so a bucket-padded prefill decodes as an exact-length one."""
    b, s = tokens.shape
    max_len = max_len or s
    positions = torch.arange(s, device=tokens.device)
    x = _embed(params, cfg, tokens)
    if seq_lens is not None:
        seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=tokens.device)
    h, caches = lc.segments_prefill(params["blocks"], x, cfg, positions=positions,
                                    max_len=max_len, seq_lens=seq_lens)
    if seq_lens is None:
        h_last = h[:, -1:, :]
    else:
        rows = torch.arange(b, device=tokens.device)
        h_last = h[rows, seq_lens.to(torch.int64) - 1][:, None, :]
        caches = lc.set_cache_lengths(caches, seq_lens)
    return _logits(params, cfg, h_last)[:, 0], caches


def lm_prefill_chunked(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                       max_len: int | None = None, seq_lens=None, chunk: int = 64):
    """Blockwise prefill: the prompt runs as chunks of ``chunk`` tokens
    through the verify path, each chunk's K/V appended at cache positions
    len .. len + c - 1 and its queries attending causally to everything
    cached so far (the decode attend with per-query lengths), so live
    activations are O(B * chunk), not O(B * S). The head runs once on the
    last real token's hidden state: the same (logits, caches) contract as
    lm_prefill. ``chunk`` must divide the padded length S (power-of-two
    buckets and chunks do). The lowering an interleaved prefill runs a
    slice per tick: its tokens equal this one's bit for bit."""
    if cfg.use_mla:
        raise ValueError("chunked prefill requires GQA blocks (the verify path); MLA's "
                         "absorbed cache decodes one token at a time")
    b, s = tokens.shape
    max_len = max_len or s
    c = min(int(chunk), s)
    if c < 1 or s % c:
        raise ValueError(f"chunk ({chunk}) must divide the padded prefill length ({s})")
    caches, h_last = lm_prefill_slice_init(cfg, b, max_len, device=tokens.device)
    lens = torch.full((b,), s, dtype=torch.int32, device=tokens.device) \
        if seq_lens is None else \
        torch.as_tensor(seq_lens, dtype=torch.int32, device=tokens.device)
    for pos in range(0, s, c):
        h_last, caches = lm_prefill_slice(params, cfg, caches, tokens[:, pos:pos + c],
                                          h_last, lens, pos)
    return lm_prefill_slice_finish(params, cfg, caches, h_last, lens)


def lm_prefill_slice_init(cfg: ModelConfig, batch: int, max_len: int, *, device):
    """Empty state of an interleaved (slice-at-a-time) prefill: transient
    decode caches at the serving pool's length, in its codec, and a zero
    h_last buffer (B, 1, d) the slices write each row's last real hidden
    state into."""
    caches = lc.init_segment_caches(cfg, batch, max_len, dtype=lc.cdt(cfg), device=device)
    h_last = torch.zeros((batch, 1, cfg.d_model), dtype=lc.cdt(cfg), device=device)
    return caches, h_last


def lm_prefill_slice(params: dict, cfg: ModelConfig, caches: list, tokens: torch.Tensor,
                     h_last: torch.Tensor, seq_lens: torch.Tensor, pos: int):
    """One slice of an interleaved prefill: tokens (B, C) are prompt
    positions pos .. pos + C - 1 (right-padded rows included); their K/V go
    to cache positions len .. len + C - 1 through the verify path (caches
    updated in place), and a row whose last real token (seq_lens - 1) falls
    in this slice has its hidden state taken into h_last (B, 1, d) on the
    device (``torch.where``: no host sync). No head runs here:
    lm_prefill_slice_finish applies it once. ``pos`` is a host int."""
    c = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    h, caches = lc.segments_verify(params["blocks"], x, cfg, caches)
    last = seq_lens.to(torch.int64) - 1
    idx = torch.clamp(last - pos, 0, c - 1)
    row = torch.gather(h, 1, idx[:, None, None].expand(-1, 1, h.shape[-1]))
    hit = (last >= pos) & (last < pos + c)
    return torch.where(hit[:, None, None], row, h_last), caches


def lm_prefill_slice_finish(params: dict, cfg: ModelConfig, caches: list,
                            h_last: torch.Tensor, seq_lens: torch.Tensor):
    """Close an interleaved prefill: the head on the taken last-token
    hidden states, and every layer's length reset to the rows' true lengths
    (pad positions past seq_lens become invisible, as after lm_prefill)."""
    seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=h_last.device)
    caches = lc.set_cache_lengths(caches, seq_lens)
    return _logits(params, cfg, h_last)[:, 0], caches


def lm_prefill_ctx(params: dict, cfg: ModelConfig, tokens: torch.Tensor, ctx: list,
                   ctx_lens, *, max_len: int, seq_lens):
    """Suffix prefill continuing a cached prefix (the radix prefix cache).

    tokens (B, S) hold only each prompt's suffix (right-padded, seq_lens
    (B,) true suffix lengths); ctx is one cached-prefix {"k", "v"} per layer
    gathered from the paged pool (kvcache.gather_prefix_context), ctx_lens
    (B,) its valid tokens (0 = none). Suffix tokens run at absolute
    positions ctx_lens[b] + j and attend to the prefix and, causally, to
    the suffix; the caches returned hold the suffix K/V only (len =
    seq_lens), which the engine scatters into the slot's own blocks."""
    s = tokens.shape[1]
    ctx_lens = torch.as_tensor(ctx_lens, dtype=torch.int32, device=tokens.device)
    seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=tokens.device)
    positions = ctx_lens[:, None] + torch.arange(s, device=tokens.device)[None, :]
    x = _embed(params, cfg, tokens)
    h, caches = lc.segments_prefill(params["blocks"], x, cfg, positions=positions,
                                    max_len=max_len, seq_lens=seq_lens, ctx=ctx,
                                    ctx_len=ctx_lens)
    rows = torch.arange(h.shape[0], device=tokens.device)
    h_last = h[rows, seq_lens.to(torch.int64) - 1][:, None, :]
    caches = lc.set_cache_lengths(caches, seq_lens)
    return _logits(params, cfg, h_last)[:, 0], caches


def lm_decode(params: dict, cfg: ModelConfig, caches: list, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, Vp), caches updated in place)."""
    x = _embed(params, cfg, tokens)
    h, caches = lc.segments_decode(params["blocks"], x, cfg, caches)
    return _logits(params, cfg, h)[:, 0], caches


def lm_verify(params: dict, cfg: ModelConfig, caches: list, tokens: torch.Tensor):
    """Speculative-decoding verify: tokens (B, S) = [last emitted token,
    then S - 1 draft tokens] -> (logits (B, S, Vp), caches updated in
    place). Token j's exact K/V lands at position len + j and its logits
    are the target's distribution of the next token given the prefix
    through token j: what sequential decode gives when drafts 1..j were all
    accepted. ``len`` advances by S; the engine rolls it back to len +
    accepted (entries past len are invisible to every read)."""
    x = _embed(params, cfg, tokens)
    h, caches = lc.segments_verify(params["blocks"], x, cfg, caches)
    return _logits(params, cfg, h), caches


def lm_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> list:
    return lc.init_segment_caches(cfg, batch, max_len, dtype=lc.cdt(cfg),
                                  device=device)


def lm_init_paged_cache(cfg: ModelConfig, n_blocks: int, block_size: int,
                        max_batch: int, n_pages: int, *, device) -> list:
    """Paged decode pool (a shared block pool + per-slot block tables)."""
    return lc.init_paged_segment_caches(cfg, n_blocks, block_size, max_batch, n_pages,
                                        dtype=lc.cdt(cfg), device=device)


def lm_cache_insert(pool: list, new: list, slots) -> list:
    """Slot-indexed cache insert for the continuous-batching engine."""
    return lc.cache_insert_slots(pool, new, slots)
