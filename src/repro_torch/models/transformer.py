"""Decoder LM for the dense and MoE archs, GQA or MLA (port of
repro/models/transformer.py: the training loss with DeepSeek-V3's
multi-token prediction head, and serving's init, prefill, chunked and
interleaved (sliced) prefill, suffix prefill against a cached prefix,
decode, the speculative verify, contiguous and paged caches; MLA models
take the prefill, decode and contiguous caches only, as in repro). Serving
ignores the MTP head, as repro's does."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm_common as lc
from repro_torch.nn import layers as nn

# path regex -> logical axes (distributed/sharding.py); first match wins
PARAM_RULES = [
    (r"embed/table$", ("vocab", "embed")),
    (r"head/w$", ("embed", "vocab")),
    (r"attn/wq/w$", ("embed", "heads")),
    (r"attn/wq/b$", ("heads",)),
    (r"attn/w[kv]/w$", ("embed", "kv_heads")),
    (r"attn/w[kv]/b$", ("kv_heads",)),
    (r"attn/wo/w$", ("heads", "embed")),
    (r"attn/w_dq/w$", ("embed", "kv_lora")),
    (r"attn/w_uq/w$", ("kv_lora", "heads")),
    (r"attn/w_dkv/w$", ("embed", "kv_lora")),
    (r"attn/w_u[kv]/w$", ("kv_lora", "heads")),
    (r"ffn/w_(gate|up)/w$", ("embed", "mlp")),
    (r"ffn/w_down/w$", ("mlp", "embed")),
    (r"ffn/bin_in/w_latent$", ("embed", "mlp")),
    (r"ffn/bin_in/scale$", ("mlp",)),
    (r"ffn/bin_out/w_latent$", ("mlp", "embed")),
    (r"ffn/bin_out/scale$", ("embed",)),
    (r"ffn/router/w$", ("embed", None)),
    (r"ffn/router/bias$", (None,)),
    (r"ffn/w_(gate|up)$", ("expert", "embed", None)),   # MoE expert stacks
    (r"ffn/w_down$", ("expert", None, "embed")),
    (r"ffn/s_(mid|out)$", ("expert", None)),
    (r"ffn/shared/w_(gate|up)/w$", ("embed", "mlp")),
    (r"ffn/shared/w_down/w$", ("mlp", "embed")),
    (r"(ln1|ln2|ln_f|q_norm|k_norm|kv_norm)/(scale|bias)$", ("embed",)),
    (r"mtp/proj/w$", ("embed", "embed")),
]

# shared-expert rules must match before the generic expert-stack rules
PARAM_RULES.sort(key=lambda r: 0 if "shared" in r[0] else 1)


def lm_init(cfg: ModelConfig, seed: int, *, device="cuda", packed: bool = True) -> dict:
    """Random params on ``device`` from a seeded torch.Generator, with
    repro's init distributions (not its numbers: the tests carry repro's
    own params over with models/convert.py). ``packed``: add each binary
    dense's serving copy of its sign words; the trainer asks for latents
    only (packed=False)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=device)
    vp = lc.padded_vocab(cfg.vocab)
    p = {"embed": nn.embedding_init(vp, cfg.d_model, dtype=lc.pdt(cfg), **kw),
         "blocks": [lc.block_init(cfg, lc.block_sig(cfg, i), packed=packed, **kw)
                    for i in range(cfg.n_layers)],
         "ln_f": nn.rmsnorm_init(cfg.d_model, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = nn.dense_init(cfg.d_model, vp, dtype=lc.pdt(cfg), **kw)
    if cfg.use_mtp:
        p["mtp"] = {"proj": nn.dense_init(2 * cfg.d_model, cfg.d_model, dtype=lc.pdt(cfg), **kw),
                    "block": lc.block_init(cfg, _mtp_sig(cfg), packed=packed, **kw),
                    "ln": nn.rmsnorm_init(cfg.d_model, device=device)}
    return p


def _mtp_sig(cfg: ModelConfig) -> lc.BlockSig:
    """The MTP head's block: the model's attention, a float dense FFN."""
    return lc.BlockSig("mla" if cfg.use_mla else "gqa", "float", False)


def _logits(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The head (vocab-parallel where the vocab is split: lc.head_logits)."""
    x = nn.rmsnorm_apply(p["ln_f"], x)
    if cfg.tie_embeddings:
        return lc.head_logits(p["embed"], x, cfg, tied=True)
    return lc.head_logits(p["head"], x, cfg)


def _embed(p: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The embedding (vocab-parallel where the vocab is split:
    lc.embed_tokens)."""
    return lc.embed_tokens(p["embed"], tokens, cfg)


def lm_loss(params: dict, cfg: ModelConfig, batch: dict):
    """The training loss (repro/models/transformer.py:87-112) -> (loss,
    {"ce", "aux", "loss"}, and "mtp_ce" with an MTP head): mean token
    cross-entropy with z-loss plus 0.01 x the blocks' aux loss, over
    ``batch`` {"tokens", "labels"} (B, S). Binary FFNs read their latents
    (the STE); attention runs the flash kernel on the card, differentiable
    through its recompute.

    DeepSeek-V3's MTP head (``cfg.use_mtp``) predicts token t + 2 from the
    final hidden state at t, normed, beside the embedding of token t + 1
    (the label at t): proj(2d -> d), one float block, the shared head; its
    cross-entropy over labels[:, 1:] against its logits[:, :-1] adds 0.3 x
    to the loss."""
    tokens, labels = batch["tokens"], batch["labels"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = _embed(params, cfg, tokens)
    h, aux = lc.segments_apply(params["blocks"], x, cfg, positions=positions)
    ce = lc.softmax_xent(_logits(params, cfg, h), labels)
    loss = ce + 0.01 * aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.use_mtp:
        mtp = params["mtp"]
        hcat = torch.cat([nn.rmsnorm_apply(mtp["ln"], h), _embed(params, cfg, labels)],
                         dim=-1)
        h2 = nn.dense_apply(mtp["proj"], hcat, compute_dtype=lc.cdt(cfg))
        h2, _ = lc.block_apply(mtp["block"], h2, cfg, _mtp_sig(cfg), positions=positions)
        ce2 = lc.softmax_xent(_logits(params, cfg, h2)[:, :-1], labels[:, 1:])
        loss = loss + 0.3 * ce2
        metrics["mtp_ce"] = ce2
    metrics["loss"] = loss
    return loss, metrics


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
