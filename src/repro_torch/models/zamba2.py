"""Zamba2 (port of repro/models/zamba2.py): a Mamba2 backbone with one
SHARED attention + MLP block invoked after every ``attn_every`` mamba
blocks: one set of weights, reused at each invocation (the per-invocation
LoRA adapters are omitted, as in repro).

repro scans its mamba blocks in flag-uniform runs (``_runs``, param keys
``blocks/run{i}``); the port keeps one param dict per block in ``blocks``
and loops over them (models/convert.py splits repro's runs). The decode
cache is {"mamba": one {"h", "conv"} f32 state per block, "attn": one
``cfg.kv_cache`` codec cache per invocation of the shared block}; repro
stacks the latter on a leading axis.

On a card the binary blocks' ``in_zx`` and ``out`` run B2, the shared
block's prefill attention B3, and an int8 pool the insert kernel (every
prefill and step) and kv_decode (every step). The SSD, the conv and the
recurrent update stay plain torch, as repro keeps them in XLA.

Tensor-parallel (launch/specs.serving_plan): the Mamba2 blocks split by
their heads (models/mamba2.py), the shared block as a GQA block (its
heads, its codec caches' KV heads, wo row-parallel; its FFN's hidden
width), the embedding and the head by the vocab.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm_common as lc
from repro_torch.models import mamba2
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers as nn
from repro_torch.serving import kvcache as kvc

# path regex -> logical axes (distributed/sharding.py); first match wins
PARAM_RULES = [
    (r"embed/table$", ("vocab", "embed")),
    (r"head/w$", ("embed", "vocab")),
    (r"in_zx/(w$|bin/w_latent$)", ("embed", "mlp")),
    (r"in_zx/bin/scale$", ("mlp",)),
    (r"in_bcdt/w$", ("embed", None)),
    (r"out/(w$|bin/w_latent$)", ("mlp", "embed")),
    (r"out/bin/scale$", ("embed",)),
    (r"conv_w$", (None, "dconv")),
    (r"conv_b$", ("dconv",)),
    (r"(a_log|d_skip|dt_bias)$", (None,)),
    (r"gnorm/scale$", ("mlp",)),
    (r"shared/attn/wq/w$", ("embed", "heads")),
    (r"shared/attn/w[kv]/w$", ("embed", "kv_heads")),
    (r"shared/attn/wo/w$", ("heads", "embed")),
    (r"shared/ffn/w_(gate|up)/w$", ("embed", "mlp")),
    (r"shared/ffn/w_down/w$", ("mlp", "embed")),
    (r"(norm|ln1|ln2|ln_f)/(scale|bias)$", ("embed",)),
]


def mesh_cuts(cfg: ModelConfig, mixer: bool) -> list:
    """MeshRules.cuts: the Mamba2 blocks' (mamba2.mesh_cuts). Where their
    heads do not split, the spec's ``mlp`` may still split the shared
    block's FFN, so the blocks' leaves and state are cut whole."""
    return mamba2.mesh_cuts(cfg, mixer, r"^blocks/\d+/")


def _flags(cfg: ModelConfig) -> list[bool]:
    return [cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers)]


def _runs(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """[(start, count, binary)]: repro's flag-uniform runs, split at group
    edges (i % attn_every == 0) and at changes of the binary flag, whose
    params it stacks as ``blocks/run{i}``."""
    runs = []
    for i, f in enumerate(_flags(cfg)):
        if runs and runs[-1][2] == f and i % cfg.attn_every:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1, f)
        else:
            runs.append((i, 1, f))
    return runs


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """The shared block runs after every ``attn_every``-th mamba block."""
    return (i + 1) % cfg.attn_every == 0


def n_shared_calls(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.attn_every


def zamba_init(cfg: ModelConfig, seed: int, *, device="cuda", packed: bool = True) -> dict:
    """Random params on ``device`` from a seeded torch.Generator, with
    repro's init distributions (not its numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=device)
    vp = lc.padded_vocab(cfg.vocab)
    return {
        "embed": nn.embedding_init(vp, cfg.d_model, dtype=lc.pdt(cfg), **kw),
        "blocks": [mamba2.mamba_init(cfg, binary=f, packed=packed, **kw) for f in _flags(cfg)],
        "shared": {"ln1": nn.rmsnorm_init(cfg.d_model, device=device),
                   "attn": lc.gqa_init(cfg, **kw),
                   "ln2": nn.rmsnorm_init(cfg.d_model, device=device),
                   "ffn": lc.ffn_init(cfg, binary=False, **kw)},
        "ln_f": nn.rmsnorm_init(cfg.d_model, device=device),
        "head": nn.dense_init(cfg.d_model, vp, dtype=lc.pdt(cfg), **kw),
    }


def _shared_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, positions) -> torch.Tensor:
    x = x + lc.gqa_apply(p["attn"], nn.rmsnorm_apply(p["ln1"], x), cfg, positions=positions)
    return x + lc.ffn_apply(p["ffn"], nn.rmsnorm_apply(p["ln2"], x), cfg)


def _shared_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, positions, max_len: int):
    """_shared_apply that also emits this invocation's cache, encoded by the
    ``cfg.kv_cache`` codec (the one gqa_decode reads) after attention used
    the exact K/V."""
    b, s, _ = x.shape
    q, k, v = lc.gqa_qkv(p["attn"], nn.rmsnorm_apply(p["ln1"], x), cfg, positions)
    o = attn_lib.prefill_attention(q, k, v, chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    x = x + lc._out_proj(p["attn"]["wo"], o.reshape(b, s, -1), cfg)
    cache = kvc.get_codec(cfg.kv_cache).from_prefill(k, v, max_len)
    return x + lc.ffn_apply(p["ffn"], nn.rmsnorm_apply(p["ln2"], x), cfg), cache


def _shared_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    a, cache = lc.gqa_decode(p["attn"], nn.rmsnorm_apply(p["ln1"], x), cfg, cache)
    x = x + a
    return x + lc.ffn_apply(p["ffn"], nn.rmsnorm_apply(p["ln2"], x), cfg), cache


def zamba_hidden(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                 collect_caches: bool = False, max_len: int | None = None):
    """-> (hidden states (B, S, d), the caches when ``collect_caches``
    (prefill), else None)."""
    s = tokens.shape[1]
    positions = torch.arange(s, device=tokens.device)
    x = lc.embed_tokens(params["embed"], tokens, cfg)
    mcaches, acaches = [], []
    for i, p in enumerate(params["blocks"]):
        if collect_caches:
            x, st = mamba2.mamba_apply(p, x, cfg, return_state=True)
            mcaches.append(st)
        else:
            x = mamba2.mamba_apply(p, x, cfg)
        if _shared_after(cfg, i):
            if collect_caches:
                x, c = _shared_prefill(params["shared"], x, cfg, positions, max_len or s)
                acaches.append(c)
            else:
                x = _shared_apply(params["shared"], x, cfg, positions)
    return x, ({"mamba": mcaches, "attn": acaches} if collect_caches else None)


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return lc.head_logits(params["head"], nn.rmsnorm_apply(params["ln_f"], h), cfg)


def zamba_loss(params: dict, cfg: ModelConfig, batch: dict):
    """Mean token cross-entropy with z-loss over ``batch`` {"tokens",
    "labels"} -> (ce, {"ce", "loss"})."""
    h, _ = zamba_hidden(params, cfg, batch["tokens"])
    ce = lc.softmax_xent(_logits(params, cfg, h), batch["labels"])
    return ce, {"ce": ce, "loss": ce}


def zamba_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                  max_len: int | None = None):
    """-> (last-token logits (B, Vp), caches)."""
    h, caches = zamba_hidden(params, cfg, tokens, collect_caches=True, max_len=max_len)
    return _logits(params, cfg, h[:, -1:, :])[:, 0], caches


def zamba_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    codec = kvc.get_codec(cfg.kv_cache)
    return {"mamba": [mamba2.mamba_init_cache(cfg, batch, device=device)
                      for _ in range(cfg.n_layers)],
            "attn": [codec.init(batch, max_len, lc.cache_kv_heads(cfg), cfg.kv_head_dim(),
                                lc.cdt(cfg), device=device) for _ in range(n_shared_calls(cfg))]}


def zamba_decode(params: dict, cfg: ModelConfig, caches: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, Vp), caches): new mamba states; each
    shared invocation's codec cache written in place."""
    x = lc.embed_tokens(params["embed"], tokens, cfg)
    new_m, new_a = [], []
    for i, (p, c) in enumerate(zip(params["blocks"], caches["mamba"])):
        x, c = mamba2.mamba_decode(p, x, cfg, c)
        new_m.append(c)
        if _shared_after(cfg, i):
            x, a = _shared_decode(params["shared"], x, cfg, caches["attn"][len(new_a)])
            new_a.append(a)
    return _logits(params, cfg, x)[:, 0], {"mamba": new_m, "attn": new_a}
