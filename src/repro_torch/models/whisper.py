"""Whisper-style encoder-decoder (port of repro/models/whisper.py). The conv
audio front end is a stub, as in repro: the inputs are precomputed frame
embeddings (B, T_enc, d).

Encoder blocks: layer norm, non-causal self-attention over the frames
(sinusoidal positions, no rope), a float FFN. Decoder blocks: causal
self-attention, cross-attention over the encoder's states, an FFN (binary
in the interior blocks, by the precision policy), each behind a layer norm;
a learned position table of ``MAX_DEC_LEN`` rows.

repro stacks the decoder's blocks in runs of one structure
(``_dec_segments``) and the encoder's in one stack; the port keeps one
param dict per layer in ``enc_blocks`` and ``dec_blocks`` and loops over
them (models/convert.py splits repro's stacks). The decode cache is one
dict per decoder layer: the self-attention K/V, bf16 and contiguous (no
codec, no pool: get_model refuses another ``kv_cache``), and the cross
K/V ``ek`` / ``ev`` (B, T_enc, Hkv, D) computed once at prefill. A decode
step writes ``k``, ``v`` and ``len`` in place.

On a card the encoder's self-attention, the decoder's causal prefill and
every cross-attention (prefill and decode) run the flash kernel (B3); the
decoder's one-token self-attention decode stays plain torch, as repro keeps
it in XLA. A binary FFN runs B2.

Tensor-parallel (launch/specs.serving_plan): every attention, the
cross-attention's too, splits by heads (wq / wk / wv columns, the rank's
heads of the self and cross caches, wo row-parallel with its bias added
once), the FFNs by their hidden width, the embedding and the head by the
padded vocab; the frames and the position tables stay whole.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.kv_quant import pad_time
from repro_torch.models import lm_common as lc
from repro_torch.nn import attention as attn_lib
from repro_torch.nn import layers as nn

# path regex -> logical axes (distributed/sharding.py); first match wins
PARAM_RULES = [
    (r"embed/table$", ("vocab", "embed")),
    (r"pos_emb$", ("seq", "embed")),
    (r"(attn|xattn)/wq/w$", ("embed", "heads")),
    (r"(attn|xattn)/wq/b$", ("heads",)),
    (r"(attn|xattn)/w[kv]/w$", ("embed", "kv_heads")),
    (r"(attn|xattn)/w[kv]/b$", ("kv_heads",)),
    (r"(attn|xattn)/wo/w$", ("heads", "embed")),
    (r"ffn/w_(gate|up)/w$", ("embed", "mlp")),
    (r"ffn/w_down/w$", ("mlp", "embed")),
    (r"ffn/bin_in/w_latent$", ("embed", "mlp")),
    (r"ffn/bin_in/scale$", ("mlp",)),
    (r"ffn/bin_out/w_latent$", ("mlp", "embed")),
    (r"ffn/bin_out/scale$", ("embed",)),
    (r"head/w$", ("embed", "vocab")),
    (r"(ln1|ln2|ln3|ln_f|ln_enc)/(scale|bias)$", ("embed",)),
]

MAX_DEC_LEN = 32768 * 2  # learned positional table upper bound


def _enc_block_init(cfg: ModelConfig, *, generator, device) -> dict:
    kw = dict(generator=generator, device=device)
    return {"ln1": nn.layernorm_init(cfg.d_model, device=device),
            "attn": lc.gqa_init(cfg, **kw),
            "ln2": nn.layernorm_init(cfg.d_model, device=device),
            "ffn": lc.ffn_init(cfg, binary=False, **kw)}


def _dec_block_init(cfg: ModelConfig, *, binary: bool, generator, device,
                    packed: bool = True) -> dict:
    kw = dict(generator=generator, device=device)
    return {"ln1": nn.layernorm_init(cfg.d_model, device=device),
            "attn": lc.gqa_init(cfg, **kw),
            "ln2": nn.layernorm_init(cfg.d_model, device=device),
            "xattn": lc.gqa_init(cfg, **kw),
            "ln3": nn.layernorm_init(cfg.d_model, device=device),
            "ffn": lc.ffn_init(cfg, binary=binary, packed=packed, **kw)}


def _dec_segments(cfg: ModelConfig) -> list[tuple[int, int, bool]]:
    """[(start, count, binary)]: repro's runs of decoder blocks of one
    structure, whose params it stacks as ``dec_blocks/seg{i}``."""
    segs = []
    for i in range(cfg.n_layers):
        f = cfg.policy.block_is_binary(i, cfg.n_layers)
        if segs and segs[-1][2] == f:
            segs[-1] = (segs[-1][0], segs[-1][1] + 1, f)
        else:
            segs.append((i, 1, f))
    return segs


def whisper_init(cfg: ModelConfig, seed: int, *, device="cuda", packed: bool = True) -> dict:
    """Random params on ``device`` from a seeded torch.Generator, with
    repro's init distributions (not its numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    kw = dict(generator=gen, device=device)
    vp = lc.padded_vocab(cfg.vocab)
    return {
        "enc_blocks": [_enc_block_init(cfg, **kw) for _ in range(cfg.enc_layers)],
        "ln_enc": nn.layernorm_init(cfg.d_model, device=device),
        "embed": nn.embedding_init(vp, cfg.d_model, dtype=lc.pdt(cfg), **kw),
        "pos_emb": (torch.randn((MAX_DEC_LEN, cfg.d_model), dtype=torch.float32, **kw)
                    * 0.01).to(lc.pdt(cfg)),
        "dec_blocks": [_dec_block_init(cfg, binary=cfg.policy.block_is_binary(i, cfg.n_layers),
                                       packed=packed, **kw)
                       for i in range(cfg.n_layers)],
        "ln_f": nn.layernorm_init(cfg.d_model, device=device),
        "head": nn.dense_init(cfg.d_model, vp, dtype=lc.pdt(cfg), **kw),
    }


def _encode(params: dict, cfg: ModelConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T_enc, d), the stub front end's output, plus sinusoidal
    positions, through the encoder blocks and the final layer norm."""
    b, t, _ = frames.shape
    pos = nn.sinusoidal_positions(t, cfg.d_model, device=frames.device)
    x = frames.to(lc.cdt(cfg)) + pos.to(lc.cdt(cfg))[None]
    positions = torch.arange(t, device=frames.device)
    for p in params["enc_blocks"]:
        h = nn.layernorm_apply(p["ln1"], x)
        q, k, v = lc.gqa_qkv(p["attn"], h, cfg, positions)
        o = attn_lib.cross_attention(q, k, v, impl=cfg.attn_impl)
        x = x + lc._out_proj(p["attn"]["wo"], o.reshape(b, t, -1), cfg)
        h = nn.layernorm_apply(p["ln2"], x)
        x = x + lc.ffn_apply(p["ffn"], h, cfg)
    return nn.layernorm_apply(params["ln_enc"], x)


def _xattn_kv(p: dict, enc: torch.Tensor, cfg: ModelConfig):
    """The cross-attention's K and V (B, T_enc, Hkv, D) over the encoder's
    states: the heads these weights hold."""
    b, t, _ = enc.shape
    dh = cfg.kv_head_dim()
    return (lc._dense(p["wk"], enc, cfg).reshape(b, t, -1, dh),
            lc._dense(p["wv"], enc, cfg).reshape(b, t, -1, dh))


def _xattn(p: dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    b, s, _ = x.shape
    q = lc._dense(p["wq"], x, cfg).reshape(b, s, -1, cfg.kv_head_dim())
    o = attn_lib.cross_attention(q, k, v, impl=cfg.attn_impl)
    return lc._out_proj(p["wo"], o.reshape(b, s, -1), cfg)


def _dec_prefill_block(p: dict, x: torch.Tensor, cfg: ModelConfig, enc: torch.Tensor,
                       positions):
    """One decoder block over the whole sequence -> (x, k, v, ek, ev)."""
    b, s, _ = x.shape
    h = nn.layernorm_apply(p["ln1"], x)
    q, k, v = lc.gqa_qkv(p["attn"], h, cfg, positions)
    o = attn_lib.prefill_attention(q, k, v, chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    x = x + lc._out_proj(p["attn"]["wo"], o.reshape(b, s, -1), cfg)
    h = nn.layernorm_apply(p["ln2"], x)
    ek, ev = _xattn_kv(p["xattn"], enc, cfg)
    x = x + _xattn(p["xattn"], h, ek, ev, cfg)
    h = nn.layernorm_apply(p["ln3"], x)
    return x + lc.ffn_apply(p["ffn"], h, cfg), k, v, ek, ev


def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = lc.embed_tokens(params["embed"], tokens, cfg)
    return x + params["pos_emb"][:tokens.shape[1]].to(lc.cdt(cfg))[None]


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return lc.head_logits(params["head"], nn.layernorm_apply(params["ln_f"], x), cfg)


def whisper_loss(params: dict, cfg: ModelConfig, batch: dict):
    """The training loss over ``batch`` {"frames" (B, T_enc, d), "tokens",
    "labels" (B, S)} -> (ce, {"ce", "loss"})."""
    enc = _encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    for p in params["dec_blocks"]:
        x = _dec_prefill_block(p, x, cfg, enc, positions)[0]
    ce = lc.softmax_xent(_logits(params, cfg, x), batch["labels"])
    return ce, {"ce": ce, "loss": ce}


def whisper_prefill(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                    frames: torch.Tensor, *, max_len: int | None = None):
    """-> (last-token logits (B, Vp), one cache per decoder layer: the
    self-attention K/V padded to max_len, ``len``, and the cross K/V)."""
    enc = _encode(params, cfg, frames)
    b, s = tokens.shape
    max_len = max_len or s
    positions = torch.arange(s, device=tokens.device)
    x = _embed(params, cfg, tokens)
    caches = []
    for p in params["dec_blocks"]:
        x, k, v, ek, ev = _dec_prefill_block(p, x, cfg, enc, positions)
        caches.append({"k": pad_time(k, max_len), "v": pad_time(v, max_len),
                       "len": torch.full((b,), s, dtype=torch.int32, device=tokens.device),
                       "ek": ek, "ev": ev})
    return _logits(params, cfg, x[:, -1:])[:, 0], caches


def whisper_init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device) -> list:
    dh, dt, hkv = cfg.kv_head_dim(), lc.cdt(cfg), lc.cache_kv_heads(cfg)

    def one():
        c = attn_lib.init_kv_cache(batch, max_len, hkv, dh, dt, device=device)
        c["ek"] = torch.zeros((batch, cfg.n_audio_frames, hkv, dh), dtype=dt, device=device)
        c["ev"] = torch.zeros_like(c["ek"])
        return c
    return [one() for _ in range(cfg.n_layers)]


def whisper_decode(params: dict, cfg: ModelConfig, caches: list, tokens: torch.Tensor):
    """tokens (B, 1) -> (logits (B, Vp), caches updated in place). Each
    row's position is its cache length, read on the device (no host
    sync)."""
    b = tokens.shape[0]
    x = lc.embed_tokens(params["embed"], tokens, cfg)
    pos_emb = params["pos_emb"][caches[0]["len"].to(torch.int64)]          # (B, d)
    x = x + pos_emb.to(x.dtype)[:, None, :]
    for p, c in zip(params["dec_blocks"], caches):
        h = nn.layernorm_apply(p["ln1"], x)
        q, k, v = lc.gqa_qkv(p["attn"], h, cfg, c["len"][:, None])
        attn_lib.cache_update_decode(c, k, v)
        o = attn_lib.decode_attention(q, c["k"], c["v"], kv_len=c["len"], impl=cfg.attn_impl)
        x = x + lc._out_proj(p["attn"]["wo"], o.reshape(b, 1, -1), cfg)
        h = nn.layernorm_apply(p["ln2"], x)
        x = x + _xattn(p["xattn"], h, c["ek"], c["ev"], cfg)
        h = nn.layernorm_apply(p["ln3"], x)
        x = x + lc.ffn_apply(p["ffn"], h, cfg)
    return _logits(params, cfg, x)[:, 0], caches
