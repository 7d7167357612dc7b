"""Shared LM machinery (port of repro/models/lm_common.py): GQA and MLA
attention blocks, hybrid FFNs and MoE layers, the layer loop, the loss and
the decode caches.

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
that ``ffn_init`` / ``pack_tree`` add. A binary MoE block's expert stacks
stay latent in both (models/moe.py; models/deploy.py quantizes them).

MLA (DeepSeek-V2/V3, MiniCPM3) prefills with expanded K/V through the
flash kernel (q and k = [nope | rope]) and decodes matrix-absorbed against
a compressed cache {"c": (B, T, kv_lora), "kr": (B, T, dr), "len"}, which
stays dense in the compute dtype whatever ``kv_cache`` says (it is already
the family's memory optimization) and has no paged layout, as in repro.
The decode writes ``c``, ``kr`` and ``len`` in place, so that a decode tick
replays as a CUDA graph.

Tensor parallelism (serving on a ``model`` mesh; the dense and MoE
families, GQA or MLA): inside a ``distributed.sharding.tensor_parallel``
scope each rank holds its shard of every leaf (launch/specs.shard_params)
and runs this same forward on it. The head counts come from the weights'
shapes, a GQA cache holds the rank's own KV heads, and the row-parallel
products (wo, w_down, bin_out) are summed over the axis: the float ones as
f32 partial products, rounded once after the sum; bin_out's as its exact
integer dot, before the cast and the scale, so that a split binary FFN
equals the single device's bit for bit. MLA splits by heads (w_uq, w_uk,
w_uv, wo); its down projections, their norms and its compressed cache are
whole on every rank, which all write the same cache. A MoE layer's experts
split over the axis (models/moe.py).
Trained on a mesh (train/step.py), each split region's input goes through
``TensorParallel.copy``, whose gradient is summed over the axis: the
attention input of wq / wk / wv, the FFN input of w_gate / w_up / bin_in,
the head's input, and qwen3's q_norm / k_norm scales, replicated leaves
applied to this rank's heads.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binary_dense import binary_dense_apply_any, binary_dense_init, with_packed
from repro_torch.distributed.sharding import TensorParallel, active_tp, tensor_parallel
from repro_torch.kernels.kv_quant import pad_time, write_span
from repro_torch.models import moe
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


def split_tp(part: str) -> TensorParallel | None:
    """The active TensorParallel where it splits ``part`` ("attn", "ffn" or
    "vocab"), else None: that part runs as on one device."""
    tp = active_tp()
    return tp if tp is not None and getattr(tp, part) else None


class _MatmulF32Out(torch.autograd.Function):
    """x (M, K) @ w (K, N) in x's dtype with an f32 output (the card's
    ``torch.mm(out_dtype=)``, which has no derivative); the backward's
    products run in the operands' dtype, as x @ w's would. The output's
    gradient is that of its cast back to x's dtype, so it is exact there."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        return g @ w.T, x.T @ g


def row_parallel(p: dict, x: torch.Tensor, cfg: ModelConfig, tp: TensorParallel) -> torch.Tensor:
    """x (..., K / N) @ this rank's rows of w (K / N, M), summed over the
    model axis: the partial product in f32 (a bf16 product with an f32
    output on a card), one all_reduce, then the cast to the compute dtype
    and the bias, in the single device's order."""
    cd = cdt(cfg)
    x2, w = x.reshape(-1, x.shape[-1]).to(cd), p["w"].to(cd)
    if cd != torch.float32 and x2.device.type == "cuda":
        y = _MatmulF32Out.apply(x2, w)
    else:
        y = x2.to(torch.float32) @ w.to(torch.float32)
    y = tp.all_reduce(y).to(cd).reshape(*x.shape[:-1], -1)
    if "b" in p:
        y = y + p["b"].to(cd)
    return y


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
        tp = split_tp("ffn")
        if tp is not None:
            x = tp.copy(x)
        h = binary_dense_apply_any(p["bin_in"], x, mode=mode)
        # split: bin_in's columns are this rank's own, and bin_out's integer
        # dot over its rows is summed before the cast and the scale
        return binary_dense_apply_any(p["bin_out"], h, mode=mode,
                                      reduce=None if tp is None else tp.all_reduce).to(x.dtype)
    tp = split_tp("ffn")
    if tp is not None:
        x = tp.copy(x)
    down = None if tp is None else (lambda pd, h: row_parallel(pd, h, cfg, tp))
    # binary_impl matters only where these denses are the self-draft's
    # packed ones (serving/spec.binarize_draft_params)
    return nn.swiglu_apply(p, x, compute_dtype=cdt(cfg), binary_impl=cfg.spec_draft_impl,
                           down=down)


def _dense(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return nn.dense_apply(p, x, compute_dtype=cdt(cfg), binary_impl=cfg.spec_draft_impl)


def _out_proj(p: dict, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """wo over the heads' outputs (B, S, H * D), row-parallel where the
    heads are split."""
    tp = split_tp("attn")
    return _dense(p, o, cfg) if tp is None else row_parallel(p, o, cfg, tp)


def embed_tokens(p: dict, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The embedding lookup (``p``: {"table"}). Where the vocab is split,
    each rank looks up the ids in its rows, leaves zeros for the rest, and
    the ranks' rows are summed: exact, one rank holds each id."""
    tp = split_tp("vocab")
    if tp is None:
        return nn.embedding_lookup(p, tokens, compute_dtype=cdt(cfg))
    rows = p["table"].shape[0]
    local = tokens - tp.rank * rows
    mine = (local >= 0) & (local < rows)
    x = nn.embedding_lookup(p, torch.where(mine, local, 0), compute_dtype=cdt(cfg))
    return tp.all_reduce(x.masked_fill(~mine[..., None], 0))


def head_logits(p: dict, x: torch.Tensor, cfg: ModelConfig, *, tied: bool = False
                ) -> torch.Tensor:
    """The head over the normed ``x`` (``p``: the head dense, or the
    embedding where ``tied``), the pad columns masked. Where the vocab is
    split, each rank's columns are gathered into the full row (exactly),
    so that the argmax and the sampler see the same row on every rank (and
    in training, the gradient of the head's input is summed over the
    ranks' columns)."""
    tp = split_tp("vocab")
    if tp is not None:
        x = tp.copy(x)
    if tied:
        logits = nn.embedding_logits(p, x, compute_dtype=cdt(cfg))
    else:
        logits = nn.dense_apply(p, x, compute_dtype=cdt(cfg))
    if tp is not None:
        logits = tp.gather_last(logits)
    return mask_pad_logits(logits, cfg.vocab)


def cache_kv_heads(cfg: ModelConfig) -> int:
    """KV heads a cache holds here: this rank's share where the heads are
    split, else all of them."""
    tp = split_tp("attn")
    return cfg.n_kv_heads if tp is None else cfg.n_kv_heads // tp.size


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


def _head_norms(p: dict, tp: TensorParallel | None) -> tuple[dict, dict]:
    """q_norm and k_norm. Where the heads are split and autograd records
    them, both scales go through one ``copy`` (one all_reduce, in one
    order on every rank): their gradients are sums over this rank's heads."""
    qn, kn = p["q_norm"], p["k_norm"]
    if tp is None or not torch.is_grad_enabled():
        return qn, kn
    both = tp.copy(torch.stack([qn["scale"], kn["scale"]]))
    return {"scale": both[0]}, {"scale": both[1]}


def gqa_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    dh = cfg.kv_head_dim()
    tp = split_tp("attn")
    if tp is not None:
        x = tp.copy(x)
    # -1: the heads these weights hold (a rank's share where they are split)
    q = _dense(p["wq"], x, cfg).reshape(b, s, -1, dh)
    k = _dense(p["wk"], x, cfg).reshape(b, s, -1, dh)
    v = _dense(p["wv"], x, cfg).reshape(b, s, -1, dh)
    if cfg.qk_norm:
        q_norm, k_norm = _head_norms(p, tp)
        q = nn.rmsnorm_apply(q_norm, q)
        k = nn.rmsnorm_apply(k_norm, k)
    if cfg.use_rope:
        q = nn.apply_rope(q, positions, base=cfg.rope_base)
        k = nn.apply_rope(k, positions, base=cfg.rope_base)
    return q, k, v


def gqa_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions):
    """Causal self attention over the full sequence, no cache."""
    q, k, v = gqa_qkv(p, x, cfg, positions)
    o = attn_lib.prefill_attention(q, k, v, chunk=cfg.attn_chunk, impl=cfg.attn_impl)
    return _out_proj(p["wo"], o.reshape(*x.shape[:2], -1), cfg)


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
    return _out_proj(p["wo"], o.reshape(*x.shape[:2], -1), cfg), cache


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
    return _out_proj(p["wo"], o.reshape(*x.shape[:2], -1), cfg), cache


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek V2/V3, MiniCPM3)
# ---------------------------------------------------------------------------

def mla_init(cfg: ModelConfig, *, generator, device) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    c, qc = cfg.kv_lora_rank, cfg.q_lora_rank
    kw = dict(generator=generator, device=device, dtype=pdt(cfg))
    p = {}
    if qc:
        p["w_dq"] = nn.dense_init(d, qc, **kw)
        p["q_norm"] = nn.rmsnorm_init(qc, device=device)
        p["w_uq"] = nn.dense_init(qc, h * (dn + dr), **kw)
    else:
        p["w_q"] = nn.dense_init(d, h * (dn + dr), **kw)
    p["w_dkv"] = nn.dense_init(d, c + dr, **kw)
    p["kv_norm"] = nn.rmsnorm_init(c, device=device)
    p["w_uk"] = nn.dense_init(c, h * dn, **kw)
    p["w_uv"] = nn.dense_init(c, h * dv, **kw)
    p["wo"] = nn.dense_init(h * dv, d, **kw)
    return p


def _mla_heads(p: dict, cfg: ModelConfig) -> int:
    """The heads these MLA weights hold: a rank's share where they are
    split (w_uk's columns are its heads' nope dims)."""
    return p["w_uk"]["w"].shape[1] // cfg.qk_nope_dim


def _mla_q(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    """-> (q_nope, q_rope) of this rank's heads. Where the heads are split,
    the down projection and its norm run whole and their output enters
    the split w_uq through ``copy``."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_dim, cfg.qk_rope_dim
    tp = split_tp("attn")
    if "w_dq" in p:
        lat = nn.rmsnorm_apply(p["q_norm"], _dense(p["w_dq"], x, cfg))
        q = _dense(p["w_uq"], lat if tp is None else tp.copy(lat), cfg)
    else:
        q = _dense(p["w_q"], x, cfg)
    q = q.reshape(b, s, _mla_heads(p, cfg), dn + dr)
    return q[..., :dn], nn.apply_rope(q[..., dn:], positions, base=cfg.rope_base)


def _mla_ckv(p: dict, x: torch.Tensor, cfg: ModelConfig, positions):
    c = cfg.kv_lora_rank
    ckv = _dense(p["w_dkv"], x, cfg)
    c_kv = nn.rmsnorm_apply(p["kv_norm"], ckv[..., :c])
    k_rope = nn.apply_rope(ckv[..., c:][:, :, None, :], positions, base=cfg.rope_base)
    return c_kv, k_rope[:, :, 0, :]


def _mla_expanded(p: dict, x: torch.Tensor, cfg: ModelConfig, positions, kv_len=None):
    """Full-sequence MLA with expanded K/V (causal, through the flash kernel
    on a card) -> (the block's output, c_kv, k_rope). Where the heads are
    split, a rank expands and attends with its own heads and wo sums the
    ranks' outputs; c_kv and k_rope, whole on every rank, fill its cache."""
    b, s, _ = x.shape
    h, dn, dv = _mla_heads(p, cfg), cfg.qk_nope_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_ckv(p, x, cfg, positions)
    tp = split_tp("attn")
    c_in, kr = (c_kv, k_rope) if tp is None else (tp.copy(c_kv), tp.copy(k_rope))
    k_nope = _dense(p["w_uk"], c_in, cfg).reshape(b, s, h, dn)
    v = _dense(p["w_uv"], c_in, cfg).reshape(b, s, h, dv)
    kr = kr[:, :, None, :].expand(b, s, h, k_rope.shape[-1])
    o = attn_lib.mla_prefill_attention(q_nope, q_rope, k_nope, kr, v, chunk=cfg.attn_chunk,
                                       kv_len=kv_len, impl=cfg.attn_impl)
    return _out_proj(p["wo"], o.reshape(b, s, -1), cfg), c_kv, k_rope


def mla_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, positions) -> torch.Tensor:
    """Full-sequence MLA (expanded K/V, causal), no cache."""
    return _mla_expanded(p, x, cfg, positions)[0]


def mla_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """Matrix-absorbed one-token decode against the compressed cache; its
    leaves are written in place (never rebound: a captured tick replays).
    Where the heads are split, every rank writes the same whole cache and
    absorbs and attends with its own heads."""
    b = x.shape[0]
    h, dn, dv, c = _mla_heads(p, cfg), cfg.qk_nope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    positions = cache["len"][:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)              # (B, 1, H, dn / dr)
    c_kv, k_rope = _mla_ckv(p, x, cfg, positions)              # (B, 1, c), (B, 1, dr)
    write_span(cache, {"c": c_kv, "kr": k_rope}, cache["len"])
    cache["len"].add_(1)
    w_uk = p["w_uk"]["w"].reshape(c, h, dn).to(cdt(cfg))
    q_abs = torch.einsum("bshd,chd->bshc", q_nope, w_uk)
    ctx = attn_lib.mla_absorbed_decode(q_abs, q_rope, cache["c"], cache["kr"], cache["len"],
                                       sm_scale=1.0 / (dn + cfg.qk_rope_dim) ** 0.5)
    w_uv = p["w_uv"]["w"].reshape(c, h, dv).to(cdt(cfg))
    o = torch.einsum("bshc,chv->bshv", ctx, w_uv).reshape(b, 1, -1)
    return _out_proj(p["wo"], o, cfg), cache


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


def block_init(cfg: ModelConfig, sig: BlockSig, *, generator, device,
               packed: bool = True) -> dict:
    kw = dict(generator=generator, device=device)
    binary = sig.ffn == "binary"
    return {"attn": mla_init(cfg, **kw) if sig.attn == "mla" else gqa_init(cfg, **kw),
            "ffn": (moe.moe_init(cfg, binary=binary, **kw) if sig.moe
                    else ffn_init(cfg, binary=binary, packed=packed, **kw)),
            "ln1": nn.rmsnorm_init(cfg.d_model, device=device),
            "ln2": nn.rmsnorm_init(cfg.d_model, device=device)}


def _ffn(p: dict, h: torch.Tensor, cfg: ModelConfig, sig: BlockSig):
    """The block's FFN -> (output, the MoE aux loss or None)."""
    if sig.moe:
        return moe.moe_apply(p["ffn"], h, cfg)
    return ffn_apply(p["ffn"], h, cfg), None


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, sig: BlockSig, *,
                positions) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward of one block -> (x, aux); aux is the MoE balance
    loss, 0.0 for a dense block (repro/models/lm_common.py:335)."""
    h = nn.rmsnorm_apply(p["ln1"], x)
    attn = mla_apply if sig.attn == "mla" else gqa_apply
    x = x + attn(p["attn"], h, cfg, positions=positions)
    f, aux = _ffn(p, nn.rmsnorm_apply(p["ln2"], x), cfg, sig)
    return x + f, x.new_zeros((), dtype=torch.float32) if aux is None else aux


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
    the plain prefix attention, not the flash kernel, as in repro. GQA only:
    MLA's compressed cache is not paged.

    GQA K/V are encoded into the ``cfg.kv_cache`` codec after attention,
    which uses them unquantized: prefill logits are the same under every
    codec. An MLA block's cache is its compressed (c_kv, k_rope)."""
    b, s, _ = x.shape
    h = nn.rmsnorm_apply(p["ln1"], x)
    if sig.attn == "mla":
        if ctx is not None:
            raise ValueError("cached-prefix (suffix) prefill requires GQA blocks; MLA "
                             "caches are not paged")
        a, c_kv, k_rope = _mla_expanded(p["attn"], h, cfg, positions, kv_len=seq_lens)
        cache = {"c": pad_time(c_kv, max_len), "kr": pad_time(k_rope, max_len),
                 "len": torch.full((b,), s, dtype=torch.int32, device=x.device)}
    else:
        q, k, v = gqa_qkv(p["attn"], h, cfg, positions)
        if ctx is not None:
            o = attn_lib.prefix_prefill_attention(q, ctx["k"], ctx["v"], ctx_len, k, v,
                                                  kv_len=seq_lens)
        else:
            o = attn_lib.prefill_attention(q, k, v, chunk=cfg.attn_chunk, kv_len=seq_lens,
                                           impl=cfg.attn_impl)
        a = _out_proj(p["attn"]["wo"], o.reshape(b, s, -1), cfg)
        cache = kvc.get_codec(cfg.kv_cache).from_prefill(k, v, max_len)
    x = x + a
    return x + _ffn(p, nn.rmsnorm_apply(p["ln2"], x), cfg, sig)[0], cache


def block_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, sig: BlockSig,
                 cache: dict):
    h = nn.rmsnorm_apply(p["ln1"], x)
    attn = mla_decode if sig.attn == "mla" else gqa_decode
    a, cache = attn(p["attn"], h, cfg, cache)
    x = x + a
    return x + _ffn(p, nn.rmsnorm_apply(p["ln2"], x), cfg, sig)[0], cache


def block_verify(p: dict, x: torch.Tensor, cfg: ModelConfig, sig: BlockSig,
                 cache: dict):
    """block_decode for an S-token verify wave (GQA only: MLA's absorbed
    decode has no multi-token form, as in repro)."""
    if sig.attn == "mla":
        raise ValueError("speculative verify requires GQA attention blocks; MLA "
                         "families decode one token at a time")
    h = nn.rmsnorm_apply(p["ln1"], x)
    a, cache = gqa_verify(p["attn"], h, cfg, cache)
    x = x + a
    return x + _ffn(p, nn.rmsnorm_apply(p["ln2"], x), cfg, sig)[0], cache


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
    the card the recompute launches the block's kernels again). The
    recompute runs in the enclosing tensor-parallel scope, re-entered
    there: on the card autograd runs the backward on a thread of its own,
    which does not see this thread's scope. JAX's "dots" policy (keep the
    products' outputs) is not mapped."""
    if cfg.remat == "none":
        return fn
    if cfg.remat in ("block", "full"):
        import contextlib

        from torch.utils.checkpoint import checkpoint
        tp = active_tp()
        scopes = lambda: (contextlib.nullcontext(), tensor_parallel(tp))  # noqa: E731
        return lambda *a: checkpoint(fn, *a, use_reentrant=False, context_fn=scopes)
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
    """Empty decode caches, one per layer: GQA layers in the ``cfg.kv_cache``
    codec's layout, MLA layers the dense compressed cache."""
    codec = kvc.get_codec(cfg.kv_cache)

    def one(sig):
        if sig.attn == "mla":
            return {"c": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                     device=device),
                    "kr": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dtype,
                                      device=device),
                    "len": torch.zeros((batch,), dtype=torch.int32, device=device)}
        return codec.init(batch, max_len, cache_kv_heads(cfg), cfg.kv_head_dim(), dtype,
                          device=device)
    return [one(block_sig(cfg, i)) for i in range(cfg.n_layers)]


def init_paged_segment_caches(cfg: ModelConfig, n_blocks: int, block_size: int,
                              max_batch: int, n_pages: int, dtype=torch.bfloat16, *,
                              device) -> list:
    """The paged decode pool, one per layer: a shared (n_blocks, block_size,
    ...) block pool in the ``cfg.kv_cache`` codec's layout plus the slots'
    block tables (serving/kvcache.init_paged). GQA layers only: MLA's
    compressed per-slot cache has no block layout to share."""
    for si, (sig, _, _) in enumerate(build_segments(cfg)):
        if sig.attn == "mla":
            raise ValueError(
                "paged KV pool requires GQA attention blocks; "
                f"segment {si} of {cfg.name!r} is MLA (use the "
                "slot-contiguous pool for MLA families)")
    codec = kvc.get_codec(cfg.kv_cache)
    return [kvc.init_paged(codec, n_blocks, block_size, cache_kv_heads(cfg), cfg.kv_head_dim(),
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
