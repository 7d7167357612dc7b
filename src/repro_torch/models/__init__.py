"""Unified model API (port of repro/models/__init__.py, serving half):

    api = get_model(cfg)
    params = api.init(seed, device="cuda")
    logits, caches = api.prefill(params, {"tokens": t}, max_len=, seq_lens=)
    caches = api.init_cache(batch_size, max_len, device=)
    logits, caches = api.decode(params, caches, tokens)
    caches = api.cache_insert(pool, new, slots)

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
    )
