"""Unified model API (port of repro/models/__init__.py, serving half):

    api = get_model(cfg)
    params = api.init(seed, device="cuda")
    logits, caches = api.prefill(params, {"tokens": t}, max_len=, seq_lens=)
    caches = api.init_cache(batch_size, max_len, device=)
    logits, caches = api.decode(params, caches, tokens)
    caches = api.cache_insert(pool, new, slots)
    caches = api.init_paged_cache(n_blocks, block_size, max_batch, n_pages, device=)
    logits, caches = api.prefill_ctx(params, {"tokens": t}, ctx, ctx_lens,
                                     max_len=, seq_lens=)
    logits, caches = api.verify(params, caches, tokens)     # (B, S) -> (B, S, Vp)
    logits, caches = api.prefill_chunked(params, {"tokens": t}, max_len=, seq_lens=,
                                         chunk=)
    caches, h_last = api.prefill_slice_init(batch_size, max_len, device=)
    h_last, caches = api.prefill_slice(params, caches, tokens, h_last, seq_lens, pos)
    logits, caches = api.prefill_slice_finish(params, caches, h_last, seq_lens)

The port serves ``family="dense"`` with GQA attention. MLA and the other
families raise NotImplementedError (ROADMAP A8); training (``loss``)
comes with ROADMAP A7.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from repro_torch.configs.base import ModelConfig


class ModelApi(NamedTuple):
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode: Callable
    init_cache: Callable
    cache_insert: Callable
    # the paged pool's seams (radix prefix cache): init_paged_cache(n_blocks,
    # block_size, max_batch, n_pages, device=) and prefill_ctx(params, batch,
    # ctx, ctx_lens, max_len=, seq_lens=), a suffix prefill that attends to
    # a cached prefix gathered from the pool
    init_paged_cache: Callable
    prefill_ctx: Callable
    # the speculative-decoding verify step: verify(params, caches, tokens
    # (B, S)) scores S tokens in one pass, their K/V appended to the caches;
    # None for a model whose cache decodes one token at a time (MLA)
    verify: Callable | None = None
    # blockwise prefill: prefill_chunked(params, batch, max_len=, seq_lens=,
    # chunk=) runs token chunks through the verify path; the same (logits,
    # caches) contract as prefill
    prefill_chunked: Callable | None = None
    # interleaved prefill (one slice per serving tick): prefill_slice_init(
    # batch, max_len, device=) -> (caches, h_last); prefill_slice(params,
    # caches, tokens, h_last, seq_lens, pos) appends one chunk's K/V and
    # takes the rows' last hidden states (pos a host int);
    # prefill_slice_finish(params, caches, h_last, seq_lens) -> (logits,
    # caches) runs the head once and seals the lengths
    prefill_slice_init: Callable | None = None
    prefill_slice: Callable | None = None
    prefill_slice_finish: Callable | None = None


def get_model(cfg: ModelConfig) -> ModelApi:
    from repro_torch.kernels.ops import resolve_impl
    from repro_torch.nn.attention import resolve_kv_cache
    resolve_kv_cache(cfg.kv_cache)
    if cfg.policy.binary_ffn:
        resolve_impl(cfg.policy.binary_mode)
    if cfg.family != "dense" or cfg.use_mla:
        raise NotImplementedError(
            f"family {cfg.family!r} (use_mla={cfg.use_mla}) is ROADMAP A8; the "
            "port serves dense GQA transformers")
    from repro_torch.models import transformer as t
    return ModelApi(
        cfg=cfg,
        init=lambda seed, device="cuda": t.lm_init(cfg, seed, device=device),
        prefill=lambda p, b, **kw: t.lm_prefill(p, cfg, b["tokens"], **kw),
        decode=lambda p, c, tok: t.lm_decode(p, cfg, c, tok),
        init_cache=lambda bs, ml, device: t.lm_init_cache(cfg, bs, ml, device=device),
        cache_insert=t.lm_cache_insert,
        init_paged_cache=lambda nb, bsz, mb, npg, device: t.lm_init_paged_cache(
            cfg, nb, bsz, mb, npg, device=device),
        prefill_ctx=lambda p, b, ctx, cl, **kw: t.lm_prefill_ctx(p, cfg, b["tokens"], ctx,
                                                                 cl, **kw),
        verify=lambda p, c, tok: t.lm_verify(p, cfg, c, tok),
        prefill_chunked=lambda p, b, **kw: t.lm_prefill_chunked(p, cfg, b["tokens"], **kw),
        prefill_slice_init=lambda bs, ml, device: t.lm_prefill_slice_init(cfg, bs, ml,
                                                                         device=device),
        prefill_slice=lambda p, c, tok, h, sl, pos: t.lm_prefill_slice(p, cfg, c, tok, h, sl,
                                                                        pos),
        prefill_slice_finish=lambda p, c, h, sl: t.lm_prefill_slice_finish(p, cfg, c, h, sl),
    )
