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
    loss, metrics = api.loss(params, batch)      # batch: tokens, labels (B, S)
                                                 # (+ frames / patches)
    dparams = api.init_deployed(seed, device=)   # latents dropped (models/deploy.py)

``api.init(seed, device=, packed=True)`` adds each binary dense's packed
serving copy; the trainer asks for latent-only params (``packed=False``),
which ``loss`` differentiates (its binary FFNs read the latents).

The port trains and serves ``family="dense"`` and ``"moe"``, with GQA or
MLA attention (and DeepSeek-V3's MTP head in the loss). An MLA model's
hooks that need a paged or multi-token GQA cache (``init_paged_cache``,
``prefill_ctx``, ``verify``, ``prefill_chunked``, ``prefill_slice*``) are
None, as in repro, and the serving engine refuses those options with
repro's errors.

``family="whisper"`` (models/whisper.py) and ``"vlm"``
(models/llama_vision.py) take their frames or patches in the batch
(``api.prefill(params, {"tokens", "frames" | "patches"})``) and have only
prefill, decode, init_cache and loss, as in repro: no slot-indexed insert
(the serving engine refuses them), no paged pool, no verify, no slices.
whisper keeps its own bf16 caches and refuses another ``kv_cache``, with
repro's error.

The recurrent families have the same five functions and no other hook,
as in repro: ``mamba2_hybrid`` (models/zamba2.py: Mamba2 blocks with a
shared attention block, whose caches take the ``kv_cache`` codec) and
``rwkv6`` (models/rwkv6_lm.py: a recurrent state, which refuses a codec).
With no slot-indexed insert the serving engine refuses them, and the
serving launcher runs them through the bucket engine (serving/bucket.py).
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
    # the slot-indexed cache insert of the continuous-batching engine; None
    # for whisper, vlm and the recurrent families, whose caches are not a
    # slot pool
    cache_insert: Callable | None = None
    # the paged pool's seams (radix prefix cache): init_paged_cache(n_blocks,
    # block_size, max_batch, n_pages, device=) and prefill_ctx(params, batch,
    # ctx, ctx_lens, max_len=, seq_lens=), a suffix prefill that attends to
    # a cached prefix gathered from the pool; None for MLA (not paged)
    init_paged_cache: Callable | None = None
    prefill_ctx: Callable | None = None
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
    # the training loss: loss(params, {"tokens", "labels"}) -> (loss, metrics)
    loss: Callable | None = None
    # the family's sharding rules, path regex -> logical axes
    # (distributed/sharding.partition_specs), repro's tables
    param_rules: tuple = ()

    def init_deployed(self, seed: int, device="cuda"):
        """Random params with the latents dropped for quantized weights."""
        from repro_torch.models.deploy import deploy_params
        return deploy_params(self.init(seed, device=device, packed=False), self.cfg)

    @property
    def deployed_rules(self) -> list:
        """The rules of deployed or packed weights, then the family's."""
        from repro_torch.models.deploy import DEPLOYED_RULES
        return DEPLOYED_RULES + list(self.param_rules)


def mesh_cuts(cfg: ModelConfig, mixer: bool) -> list:
    """The family's MeshRules.cuts (distributed/sharding.py): the leaves
    whose rank's part is not the contiguous cut of repro's spec, declared
    beside the family's PARAM_RULES; ``mixer``: the plan splits the
    recurrent mixer's heads (launch/specs._model_split)."""
    if cfg.family == "mamba2_hybrid":
        from repro_torch.models import zamba2
        return zamba2.mesh_cuts(cfg, mixer)
    if cfg.family == "rwkv6":
        from repro_torch.models import rwkv6_lm
        return rwkv6_lm.mesh_cuts(cfg, mixer)
    return []


def get_model(cfg: ModelConfig) -> ModelApi:
    from repro_torch.kernels.ops import resolve_impl
    from repro_torch.nn.attention import resolve_kv_cache
    if resolve_kv_cache(cfg.kv_cache) != "bf16" and cfg.family in ("whisper", "rwkv6"):
        # whisper builds its own bf16 decoder / cross caches and rwkv6 keeps
        # recurrent state, not a KV pool: repro refuses a codec it would ignore
        raise ValueError(
            f"family {cfg.family!r} has no codec-backed KV pool; "
            f"kv_cache={cfg.kv_cache!r} is only supported for "
            "dense/moe/vlm/mamba2_hybrid (leave it 'auto')")
    if cfg.policy.binary_ffn:
        resolve_impl(cfg.policy.binary_mode)
    if cfg.family == "vlm":
        from repro_torch.models import llama_vision as v
        return ModelApi(
            cfg=cfg,
            init=lambda seed, device="cuda", packed=True: v.vlm_init(cfg, seed, device=device,
                                                                     packed=packed),
            prefill=lambda p, b, **kw: v.vlm_prefill(p, cfg, b["tokens"], b["patches"], **kw),
            decode=lambda p, c, tok: v.vlm_decode(p, cfg, c, tok),
            init_cache=lambda bs, ml, device: v.vlm_init_cache(cfg, bs, ml, device=device),
            loss=lambda p, b: v.vlm_loss(p, cfg, b), param_rules=tuple(v.PARAM_RULES))
    if cfg.family == "whisper":
        from repro_torch.models import whisper as w
        return ModelApi(
            cfg=cfg,
            init=lambda seed, device="cuda", packed=True: w.whisper_init(
                cfg, seed, device=device, packed=packed),
            prefill=lambda p, b, **kw: w.whisper_prefill(p, cfg, b["tokens"], b["frames"],
                                                         **kw),
            decode=lambda p, c, tok: w.whisper_decode(p, cfg, c, tok),
            init_cache=lambda bs, ml, device: w.whisper_init_cache(cfg, bs, ml, device=device),
            loss=lambda p, b: w.whisper_loss(p, cfg, b), param_rules=tuple(w.PARAM_RULES))
    if cfg.family == "mamba2_hybrid":
        from repro_torch.models import zamba2 as z
        return ModelApi(
            cfg=cfg,
            init=lambda seed, device="cuda", packed=True: z.zamba_init(cfg, seed, device=device,
                                                                       packed=packed),
            prefill=lambda p, b, **kw: z.zamba_prefill(p, cfg, b["tokens"], **kw),
            decode=lambda p, c, tok: z.zamba_decode(p, cfg, c, tok),
            init_cache=lambda bs, ml, device: z.zamba_init_cache(cfg, bs, ml, device=device),
            loss=lambda p, b: z.zamba_loss(p, cfg, b), param_rules=tuple(z.PARAM_RULES))
    if cfg.family == "rwkv6":
        from repro_torch.models import rwkv6_lm as r
        return ModelApi(
            cfg=cfg,
            init=lambda seed, device="cuda", packed=True: r.rwkv_init(cfg, seed, device=device,
                                                                      packed=packed),
            prefill=lambda p, b, **kw: r.rwkv_prefill(p, cfg, b["tokens"], **kw),
            decode=lambda p, c, tok: r.rwkv_decode(p, cfg, c, tok),
            init_cache=lambda bs, ml, device: r.rwkv_init_cache(cfg, bs, ml, device=device),
            loss=lambda p, b: r.rwkv_loss(p, cfg, b), param_rules=tuple(r.PARAM_RULES))
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"unknown family {cfg.family!r}")
    from repro_torch.models import transformer as t
    gqa = not cfg.use_mla     # MLA's compressed cache is neither paged nor multi-token

    def only_gqa(fn):
        return fn if gqa else None
    return ModelApi(
        cfg=cfg,
        init=lambda seed, device="cuda", packed=True: t.lm_init(cfg, seed, device=device,
                                                                packed=packed),
        prefill=lambda p, b, **kw: t.lm_prefill(p, cfg, b["tokens"], **kw),
        decode=lambda p, c, tok: t.lm_decode(p, cfg, c, tok),
        init_cache=lambda bs, ml, device: t.lm_init_cache(cfg, bs, ml, device=device),
        cache_insert=t.lm_cache_insert,
        init_paged_cache=only_gqa(lambda nb, bsz, mb, npg, device: t.lm_init_paged_cache(
            cfg, nb, bsz, mb, npg, device=device)),
        prefill_ctx=only_gqa(lambda p, b, ctx, cl, **kw: t.lm_prefill_ctx(
            p, cfg, b["tokens"], ctx, cl, **kw)),
        verify=only_gqa(lambda p, c, tok: t.lm_verify(p, cfg, c, tok)),
        prefill_chunked=only_gqa(lambda p, b, **kw: t.lm_prefill_chunked(
            p, cfg, b["tokens"], **kw)),
        prefill_slice_init=only_gqa(lambda bs, ml, device: t.lm_prefill_slice_init(
            cfg, bs, ml, device=device)),
        prefill_slice=only_gqa(lambda p, c, tok, h, sl, pos: t.lm_prefill_slice(
            p, cfg, c, tok, h, sl, pos)),
        prefill_slice_finish=only_gqa(lambda p, c, h, sl: t.lm_prefill_slice_finish(
            p, cfg, c, h, sl)),
        loss=lambda p, b: t.lm_loss(p, cfg, b),
        param_rules=tuple(t.PARAM_RULES),
    )
