"""Llama-3.2-Vision-style VLM backbone (port of repro/models/llama_vision.py):
a GQA decoder with a gated cross-attention block after every
``cross_every`` self-attention blocks. The vision encoder is a stub, as in
repro: the inputs are precomputed patch embeddings (B, n_patches, d_model).

Cross blocks (rmsnorm, cross-attention over the patches, a float FFN, each
added through tanh of its own scalar gate, zero at init) consume the image
and stay float under the paper's edge-layer rule; the self blocks are
lm_common's, their FFNs binary by the precision policy.

repro splits its stacked self segments at the cross boundaries and merges
the cache chunks back; the port's blocks and caches are per-layer lists, so
the walk goes over the layer index: self block i, then cross block
(i + 1) / cross_every - 1 wherever i + 1 is a multiple of ``cross_every``
(up to n_layers // cross_every of them), repro's order exactly. The decode
cache is {"self": one cache per self layer in the ``kv_cache`` codec,
"cross": the patches}; the patch K/V are computed again at every decode
step, as in repro. On a card the causal self prefill and every
cross-attention run the flash kernel (B3), binary FFNs B2, and an int8 or
binary pool its insert kernel and kv_decode.

Tensor-parallel (launch/specs.serving_plan): the self blocks as
lm_common's, the cross blocks' attention by heads (wo row-parallel) and
their FFN by its hidden width; the gates and the ``cross`` cache (the
patches) stay whole on every rank.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm_common as lc
from repro_torch.models import transformer as t
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers as nn

# path regex -> logical axes (distributed/sharding.py); first match wins
PARAM_RULES = [
    (r"xattn/wq/w$", ("embed", "heads")),
    (r"xattn/w[kv]/w$", ("embed", "kv_heads")),
    (r"xattn/wo/w$", ("heads", "embed")),
    (r"(gate_attn|gate_ffn)$", ()),
    (r"xffn/w_(gate|up)/w$", ("embed", "mlp")),
    (r"xffn/w_down/w$", ("mlp", "embed")),
    (r"(ln_x1|ln_x2)/(scale|bias)$", ("embed",)),
] + t.PARAM_RULES


def _cross_block_init(cfg: ModelConfig, *, generator, device) -> dict:
    kw = dict(generator=generator, device=device)
    return {"ln_x1": nn.rmsnorm_init(cfg.d_model, device=device),
            "xattn": lc.gqa_init(cfg, **kw),
            "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
            "ln_x2": nn.rmsnorm_init(cfg.d_model, device=device),
            "xffn": lc.ffn_init(cfg, binary=False, **kw),
            "gate_ffn": torch.zeros((), dtype=torch.float32, device=device)}


def _n_cross(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.cross_every


def vlm_init(cfg: ModelConfig, seed: int, *, device="cuda", packed: bool = True) -> dict:
    """lm_init's params plus ``cross``, one dict per cross block."""
    p = t.lm_init(cfg, seed, device=device, packed=packed)
    device = p["embed"]["table"].device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 777)
    p["cross"] = [_cross_block_init(cfg, generator=gen, device=device)
                  for _ in range(_n_cross(cfg))]
    return p


def _patch_kv(p: dict, patches: torch.Tensor, cfg: ModelConfig):
    b, n, _ = patches.shape
    dh = cfg.kv_head_dim()
    return (lc._dense(p["wk"], patches, cfg).reshape(b, n, -1, dh),
            lc._dense(p["wv"], patches, cfg).reshape(b, n, -1, dh))


def _cross_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 patches: torch.Tensor) -> torch.Tensor:
    """A gated cross block: x + tanh(gate_attn) * attention over the patches,
    then + tanh(gate_ffn) * the FFN, the residual sums in f32."""
    b, s, _ = x.shape
    h = nn.rmsnorm_apply(p["ln_x1"], x)
    q = lc._dense(p["xattn"]["wq"], h, cfg).reshape(b, s, -1, cfg.kv_head_dim())
    k, v = _patch_kv(p["xattn"], patches, cfg)
    o = attn_lib.cross_attention(q, k, v, impl=cfg.attn_impl)
    a = lc._out_proj(p["xattn"]["wo"], o.reshape(b, s, -1), cfg)
    x = x + torch.tanh(p["gate_attn"]) * a.to(torch.float32)
    h = nn.rmsnorm_apply(p["ln_x2"], x.to(a.dtype))
    f = lc.ffn_apply(p["xffn"], h, cfg)
    x = x + torch.tanh(p["gate_ffn"]) * f.to(torch.float32)
    return x.to(a.dtype)


def _interleaved(params: dict, cfg: ModelConfig, x: torch.Tensor, patches: torch.Tensor,
                 block_fn):
    """Self block i through ``block_fn(i, p, x) -> (x, out)``, then the next
    cross block wherever i + 1 is a multiple of cross_every -> (x, [out of
    each self block])."""
    outs = []
    for i, p in enumerate(params["blocks"]):
        x, out = block_fn(i, p, x)
        outs.append(out)
        ci = (i + 1) // cfg.cross_every - 1
        if (i + 1) % cfg.cross_every == 0 and ci < _n_cross(cfg):
            x = _cross_apply(params["cross"][ci], x, cfg, patches)
    return x, outs


def vlm_loss(params: dict, cfg: ModelConfig, batch: dict):
    """The training loss over ``batch`` {"patches" (B, n_patches, d),
    "tokens", "labels" (B, S)} -> (loss, {"ce", "loss"}): cross-entropy
    plus 0.01 x the blocks' aux loss."""
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x, auxs = _interleaved(params, cfg, t._embed(params, cfg, tokens), batch["patches"],
                           lambda i, p, x: lc.block_apply(p, x, cfg, lc.block_sig(cfg, i),
                                                          positions=positions))
    ce = lc.softmax_xent(t._logits(params, cfg, x), batch["labels"])
    loss = ce + 0.01 * sum(auxs)
    return loss, {"ce": ce, "loss": loss}


def vlm_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor, patches: torch.Tensor,
                *, max_len: int | None = None):
    """-> (last-token logits (B, Vp), {"self": one cache per self layer,
    "cross": patches})."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    max_len = max_len or tokens.shape[1]
    x, caches = _interleaved(params, cfg, t._embed(params, cfg, tokens), patches,
                             lambda i, p, x: lc.block_prefill(p, x, cfg, lc.block_sig(cfg, i),
                                                              positions=positions,
                                                              max_len=max_len))
    return t._logits(params, cfg, x[:, -1:])[:, 0], {"self": caches, "cross": patches}


def vlm_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> dict:
    return {"self": lc.init_segment_caches(cfg, batch, max_len, dtype=lc.cdt(cfg),
                                           device=device),
            "cross": torch.zeros((batch, cfg.n_patches, cfg.d_model), dtype=lc.cdt(cfg),
                                 device=device)}


def vlm_decode(params: dict, cfg: ModelConfig, caches: dict, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, Vp), caches, the self caches updated in
    place)."""
    x, new = _interleaved(params, cfg, t._embed(params, cfg, tokens), caches["cross"],
                          lambda i, p, x: lc.block_decode(p, x, cfg, lc.block_sig(cfg, i),
                                                          caches["self"][i]))
    return t._logits(params, cfg, x)[:, 0], {"self": new, "cross": caches["cross"]}
