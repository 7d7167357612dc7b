"""RWKV6 language model (port of repro/models/rwkv6_lm.py): Finch blocks
between an embedding and a layer-normed head. repro stacks the blocks in
runs of one binary flag (``_segments``, param keys ``blocks/seg{i}``); the
port keeps one param dict and one state {"tm_x", "tm_s", "cm_x"} per block,
in lists. The state is O(1) in the sequence length: there is no KV pool,
and get_model refuses a ``kv_cache`` codec for this family, as repro does.
On a ``model`` mesh the blocks split by heads and the channel-mix FFN
(models/rwkv6.py), the embedding and the head by the vocab.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm_common as lc
from repro_torch.models import rwkv6
from repro_torch.nn import layers as nn

# path regex -> logical axes (distributed/sharding.py); first match wins
PARAM_RULES = [
    (r"embed/table$", ("vocab", "embed")),
    (r"head/w$", ("embed", "vocab")),
    (r"w_[rkvgo]/w$", ("embed", "heads")),
    (r"w0$", ("heads",)),
    (r"w_lora_a$", ("embed", None)),
    (r"w_lora_b$", (None, "embed")),
    (r"u$", ("heads",)),
    (r"mu$", (None, "embed")),
    (r"mu_c$", (None, "embed")),
    (r"c_k/(w$|bin/w_latent$)", ("embed", "mlp")),
    (r"c_k/bin/scale$", ("mlp",)),
    (r"c_v/(w$|bin/w_latent$)", ("mlp", "embed")),
    (r"c_v/bin/scale$", ("embed",)),
    (r"c_r/w$", ("embed", "heads")),
    (r"(ln1|ln2|ln_f|gn)/(scale|bias)$", ("embed",)),
]


def mesh_cuts(cfg: ModelConfig, mixer: bool) -> list:
    """MeshRules.cuts: the token-shift mix ``mu`` (5, d) matches repro's
    ``u$`` rule before its own, so its spec splits d by heads; it mixes
    the whole x, so it stays whole."""
    return [(r"(^|/)mu$", ())]


def _segments(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """[(start, count, binary)]: repro's runs of one binary flag, whose
    params it stacks as ``blocks/seg{i}``."""
    segs = []
    for i in range(cfg.n_layers):
        f = cfg.policy.block_is_binary(i, cfg.n_layers)
        if segs and segs[-1][2] == f:
            segs[-1] = (segs[-1][0], segs[-1][1] + 1, f)
        else:
            segs.append((i, 1, f))
    return segs


def rwkv_init(cfg: ModelConfig, seed: int, *, device="cuda", packed: bool = True) -> dict:
    """Random params on ``device`` from a seeded torch.Generator, with
    repro's init distributions (not its numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=device)
    vp = lc.padded_vocab(cfg.vocab)
    return {
        "embed": nn.embedding_init(vp, cfg.d_model, dtype=lc.pdt(cfg), **kw),
        "blocks": [rwkv6.rwkv_block_init(cfg, binary=cfg.policy.block_is_binary(i, cfg.n_layers),
                                         packed=packed, **kw) for i in range(cfg.n_layers)],
        "ln_f": nn.layernorm_init(cfg.d_model, device=device),
        "head": nn.dense_init(cfg.d_model, vp, dtype=lc.pdt(cfg), **kw),
    }


def _forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor, caches: list):
    """-> (hidden states, one new state per block)."""
    x = lc.embed_tokens(params["embed"], tokens, cfg)
    new = []
    for p, c in zip(params["blocks"], caches):
        x, c = rwkv6.rwkv_block_apply(p, x, cfg, c)
        new.append(c)
    return x, new


def _logits(params: dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return lc.head_logits(params["head"], nn.layernorm_apply(params["ln_f"], h), cfg)


def rwkv_init_cache(cfg: ModelConfig, batch: int, max_len: int = 0, *, device) -> list:
    """Zero states, one per block (``max_len`` unused: the state does not
    grow)."""
    return [rwkv6.rwkv_init_cache_block(cfg, batch, device=device)
            for _ in range(cfg.n_layers)]


def rwkv_loss(params: dict, cfg: ModelConfig, batch: dict):
    """Mean token cross-entropy with z-loss over ``batch`` {"tokens",
    "labels"} -> (ce, {"ce", "loss"})."""
    tokens = batch["tokens"]
    h, _ = _forward(params, cfg, tokens,
                    rwkv_init_cache(cfg, tokens.shape[0], device=tokens.device))
    ce = lc.softmax_xent(_logits(params, cfg, h), batch["labels"])
    return ce, {"ce": ce, "loss": ce}


def rwkv_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, *,
                 max_len: int | None = None):
    """-> (last-token logits (B, Vp), the states after the prompt)."""
    h, caches = _forward(params, cfg, tokens,
                         rwkv_init_cache(cfg, tokens.shape[0], device=tokens.device))
    return _logits(params, cfg, h[:, -1:, :])[:, 0], caches


def rwkv_decode(params: dict, cfg: ModelConfig, caches: list, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, Vp), the new states)."""
    h, caches = _forward(params, cfg, tokens, caches)
    return _logits(params, cfg, h)[:, 0], caches
