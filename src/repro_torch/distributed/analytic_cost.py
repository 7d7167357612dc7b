"""Analytic FLOP / HBM-byte model for every architecture x shape cell (port
of repro/distributed/analytic_cost.py, its arithmetic line for line).

Why analytic: the counts are exact for every matmul of the model zoo, at
every config, at cluster sizes no machine here holds. The dry run
(launch/dryrun.py) records both this model and what torch's
FlopCounterMode counts on fake tensors; the roofline uses these.
Collective bytes come from the dry run's recorder
(distributed/collectives.py), the counterpart of repro's HLO parse.

FLOPs are split into precision buckets so the compute roofline can rate
binary layers at the int8 tensor-core peak; the rates are an H100 SXM5's
(distributed/hlo_analysis.py, datasheet figures):
    bf16 @ 989 TFLOP/s     int8 @ 1,979 TOP/s     xnor @ 1,979 TOP/s

Counting: multiply-add = 2 ops; causal attention halves the S^2 terms;
backward = 2x forward matmuls; remat="block" adds one forward recompute.

Where the port's representation differs from what ``weight_bytes``
assumes, the count stays repro's: deployed int8 weights are +-1 int8 (the
``w_int8`` leaf, models/deploy.py), 1 B a weight, as counted; but the
serving tree that B2 reads (``init(packed=True)``) holds the packed sign
words beside the bf16 latents, and B1 / B5 read packed words in either
mode. The dry run's argument bytes count the tree it is given.
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.hlo_analysis import PEAK_BF16, PEAK_INT8, param_count
from repro_torch.models.lm_common import padded_vocab

# NVIDIA publishes no b1 tensor-core rate for Hopper: the xnor bucket is
# rated at the int8 peak (B1 and B5 are bounded by it, PERF.md section 6)
XNOR_PEAK = PEAK_INT8


@dataclass
class StepCost:
    flops_bf16: float = 0.0
    flops_int8: float = 0.0   # +-1 binary matmuls on the int8 tensor cores
    flops_xnor: float = 0.0   # +-1 binary matmuls as packed popcounts
    hbm_bytes: float = 0.0    # global; divide by cards for per-device

    def add(self, other):
        self.flops_bf16 += other.flops_bf16
        self.flops_int8 += other.flops_int8
        self.flops_xnor += other.flops_xnor
        self.hbm_bytes += other.hbm_bytes

    def scaled(self, k):
        return StepCost(self.flops_bf16 * k, self.flops_int8 * k,
                        self.flops_xnor * k, self.hbm_bytes * k)

    @property
    def flops_total(self):
        return self.flops_bf16 + self.flops_int8 + self.flops_xnor

    def t_compute(self, n_chips, *, peak_bf16=PEAK_BF16, peak_int8=PEAK_INT8,
                  peak_xnor=XNOR_PEAK):
        return (self.flops_bf16 / peak_bf16 + self.flops_int8 / peak_int8
                + self.flops_xnor / peak_xnor) / n_chips


def _bin_bucket(cfg: ModelConfig, ops: float) -> StepCost:
    mode = cfg.policy.binary_mode
    if mode == "xnor":
        return StepCost(flops_xnor=ops)
    if mode == "int8":
        return StepCost(flops_int8=ops)
    return StepCost(flops_bf16=ops)


def _n_binary_blocks(cfg: ModelConfig) -> int:
    return sum(cfg.policy.block_is_binary(i, cfg.n_layers)
               for i in range(cfg.n_layers))


# ---------------------------------------------------------------------------
# per-component forward FLOPs (global, one step)
# ---------------------------------------------------------------------------

def _attn_gqa(cfg, b, s, t=None, *, causal=True):
    """t: kv length (defaults s). Returns StepCost of ONE layer fwd."""
    t = t or s
    dh = cfg.kv_head_dim()
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    d = cfg.d_model
    mats = 2 * b * s * d * (hq * dh) * 2 + 2 * b * s * d * (hkv * dh) * 2
    half = 0.5 if (causal and s == t) else 1.0
    scores = 2 * b * hq * s * t * dh * 2 * half
    return StepCost(flops_bf16=mats + scores)


def _attn_mla(cfg, b, s, t=None, *, decode=False):
    t = t or s
    d, h = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    c, qc = cfg.kv_lora_rank, cfg.q_lora_rank
    q = 2 * b * s * (d * qc + qc * h * (dn + dr)) if qc else \
        2 * b * s * d * h * (dn + dr)
    kv_down = 2 * b * s * d * (c + dr)
    o = 2 * b * s * h * dv * d
    if decode:
        q_abs = 2 * b * s * h * dn * c
        scores = 2 * b * h * s * t * (c + dr)
        ctx = 2 * b * h * s * t * c
        v_up = 2 * b * s * h * c * dv
        return StepCost(flops_bf16=q + kv_down + o + q_abs + scores + ctx
                        + v_up)
    k_up = 2 * b * s * c * h * dn
    v_up = 2 * b * s * c * h * dv
    half = 0.5 if s == t else 1.0
    scores = 2 * b * h * s * t * (dn + dr + dv) * half
    return StepCost(flops_bf16=q + kv_down + k_up + v_up + o + scores)


def _ffn(cfg, tokens, *, binary, d_ff=None):
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    if binary:
        return _bin_bucket(cfg, 2 * tokens * d * d_ff * 2)   # 2 matmuls
    return StepCost(flops_bf16=2 * tokens * d * d_ff * 3)    # swiglu: 3


def _moe(cfg, tokens, *, binary):
    d, e, k, fe = cfg.d_model, cfg.n_experts, cfg.top_k, cfg.moe_d_ff
    router = StepCost(flops_bf16=2 * tokens * d * e)
    shared = StepCost(
        flops_bf16=2 * tokens * d * cfg.n_shared_experts * fe * 3)
    experts = 2 * tokens * k * d * fe * 3
    out = StepCost()
    out.add(router)
    out.add(shared)
    out.add(_bin_bucket(cfg, experts) if binary
            else StepCost(flops_bf16=experts))
    return out


def _mamba(cfg, b, s, *, binary, decode=False):
    d, ds = cfg.d_model, cfg.d_state
    di = cfg.expand * d
    nh, p = di // 64, 64
    toks = b * s
    zx = 2 * toks * d * 2 * di
    bcdt = StepCost(flops_bf16=2 * toks * d * (2 * ds + nh))
    conv = StepCost(flops_bf16=2 * toks * (di + 2 * ds) * cfg.d_conv)
    outp = 2 * toks * di * d
    cost = StepCost()
    cost.add(_bin_bucket(cfg, zx + outp) if binary
             else StepCost(flops_bf16=zx + outp))
    cost.add(bcdt)
    cost.add(conv)
    if decode:
        cost.add(StepCost(flops_bf16=4 * toks * nh * p * ds))
    else:
        q = min(cfg.ssm_chunk, s)
        nc = max(s // q, 1)
        intra = 2 * b * nc * q * q * (ds + nh * p) * 0.5
        inter = 4 * b * s * nh * p * ds
        cost.add(StepCost(flops_bf16=intra + inter))
    return cost


def _rwkv_mix(cfg, b, s):
    """An RWKV6 block's products over its heads: the time-mix's
    projections, decay LoRA and WKV state ops, and the channel-mix's c_r."""
    d = cfg.d_model
    hd = cfg.head_dim or 64
    toks = b * s
    tm_proj = 2 * toks * 5 * d * d + 2 * toks * (d * 64 + 64 * d)
    wkv = 7 * toks * d * hd          # state ops per token per channel
    cm_r = 2 * toks * d * d
    return StepCost(flops_bf16=tm_proj + wkv + cm_r)


def _rwkv_ffn(cfg, b, s, *, binary):
    """An RWKV6 block's channel-mix FFN, c_k and c_v."""
    cm = 2 * b * s * cfg.d_model * cfg.d_ff * 2
    return _bin_bucket(cfg, cm) if binary else StepCost(flops_bf16=cm)


def _rwkv_block(cfg, b, s, *, binary):
    cost = _rwkv_mix(cfg, b, s)
    cost.add(_rwkv_ffn(cfg, b, s, binary=binary))
    return cost


def _cross_attn(cfg, b, s, t_ctx, *, kv=True):
    """One cross-attention layer: the queries and output over b x s
    tokens, the context's K / V over b x t_ctx (``kv``: projected this
    step) and the scores."""
    d, dh = cfg.d_model, cfg.kv_head_dim()
    mats = 2 * b * s * d * cfg.n_heads * dh * 2 \
        + (2 * b * t_ctx * d * cfg.n_kv_heads * dh * 2 if kv else 0)
    scores = 2 * b * cfg.n_heads * s * t_ctx * dh * 2
    return StepCost(flops_bf16=mats + scores)


def _head(cfg, tokens):
    return StepCost(flops_bf16=2 * tokens * cfg.d_model
                    * padded_vocab(cfg.vocab))


# ---------------------------------------------------------------------------
# forward cost of one full step
# ---------------------------------------------------------------------------

def forward_cost(cfg: ModelConfig, shape: ShapeSpec) -> StepCost:
    b = shape.global_batch
    decode = shape.kind == "decode"
    s = 1 if decode else shape.seq_len
    t = shape.seq_len
    toks = b * s
    total = StepCost()

    if cfg.family in ("dense", "moe", "vlm"):
        for i in range(cfg.n_layers):
            binary = cfg.policy.block_is_binary(i, cfg.n_layers)
            if cfg.use_mla:
                total.add(_attn_mla(cfg, b, s, t, decode=decode))
            else:
                total.add(_attn_gqa(cfg, b, s, t, causal=not decode))
            moe_layer = (cfg.family == "moe"
                         and i >= cfg.first_dense_layers)
            if moe_layer:
                total.add(_moe(cfg, toks, binary=binary))
            else:
                total.add(_ffn(cfg, toks, binary=binary))
        if cfg.family == "vlm":
            for _ in range(cfg.n_layers // cfg.cross_every):
                total.add(_cross_attn(cfg, b, s, cfg.n_patches))
                total.add(_ffn(cfg, toks, binary=False))
        if cfg.use_mtp and shape.kind == "train":
            total.add(_attn_mla(cfg, b, s, t) if cfg.use_mla
                      else _attn_gqa(cfg, b, s, t))
            total.add(_ffn(cfg, toks, binary=False))
            total.add(_head(cfg, toks))
            total.add(StepCost(flops_bf16=2 * toks * 2 * cfg.d_model
                               * cfg.d_model))
    elif cfg.family == "whisper":
        te = cfg.n_audio_frames
        if shape.kind != "decode":  # encoder runs at train/prefill
            for _ in range(cfg.enc_layers):
                total.add(_attn_gqa(cfg, b, te, te, causal=False))
                total.add(_ffn(cfg, b * te, binary=False))
        for i in range(cfg.n_layers):
            binary = cfg.policy.block_is_binary(i, cfg.n_layers)
            total.add(_attn_gqa(cfg, b, s, t, causal=not decode))
            # cross attention (kv over enc frames recomputed per layer)
            total.add(_cross_attn(cfg, b, s, te, kv=not decode))
            total.add(_ffn(cfg, toks, binary=binary))
    elif cfg.family == "mamba2_hybrid":
        for i in range(cfg.n_layers):
            binary = cfg.policy.block_is_binary(i, cfg.n_layers)
            total.add(_mamba(cfg, b, s, binary=binary, decode=decode))
        for _ in range(cfg.n_layers // cfg.attn_every):
            total.add(_attn_gqa(cfg, b, s, t, causal=not decode))
            total.add(_ffn(cfg, toks, binary=False))
    elif cfg.family == "rwkv6":
        for i in range(cfg.n_layers):
            binary = cfg.policy.block_is_binary(i, cfg.n_layers)
            total.add(_rwkv_block(cfg, b, s, binary=binary))
    else:
        raise ValueError(cfg.family)

    total.add(_head(cfg, toks if shape.kind == "train" else b))
    return total


# training flop multiplier over forward: bwd = 2x fwd matmuls; remat adds
# recompute — "block"/"full" re-run the whole forward (+1.0), "dots" saves
# matmul outputs and re-runs only elementwise (~ +0.1; the port's trainer
# refuses "dots", models/lm_common._maybe_remat)
REMAT_FACTOR = {"none": 3.0, "dots": 3.1, "block": 4.0, "full": 4.0}


def step_cost(cfg: ModelConfig, shape: ShapeSpec) -> StepCost:
    """Full step: forward (+ backward + remat recompute for training)."""
    fwd = forward_cost(cfg, shape)
    if shape.kind != "train":
        cost = fwd
    else:
        cost = fwd.scaled(REMAT_FACTOR.get(cfg.remat, 4.0))
    cost.hbm_bytes = hbm_bytes(cfg, shape)
    return cost


# ---------------------------------------------------------------------------
# HBM traffic (global bytes)
# ---------------------------------------------------------------------------

def weight_bytes(cfg: ModelConfig, *, deployed: bool = False) -> float:
    """Total parameter bytes.

    deployed=True drops binary latents for the quantized representation:
    1 bit/weight in xnor mode (bit-packed), 1 B/weight in int8 mode (the
    ``w_int8`` leaf of models/deploy.py; B2 itself reads packed words, a
    further 8x, which the serving tree holds beside its latents: module
    note)."""
    n_total = param_count(cfg)
    mode = cfg.policy.binary_mode
    if not (cfg.policy.binary_ffn and deployed) or mode == "bf16":
        return n_total * 2.0  # bf16 (latents bf16 in training too)
    nb = binary_param_count(cfg)
    per = 0.125 if mode == "xnor" else 1.0
    return (n_total - nb) * 2.0 + nb * per


def binary_param_count(cfg: ModelConfig) -> float:
    d = cfg.d_model
    nb = _n_binary_blocks(cfg)
    if cfg.family == "moe":
        n_moe_bin = sum(
            cfg.policy.block_is_binary(i, cfg.n_layers)
            and i >= cfg.first_dense_layers for i in range(cfg.n_layers))
        n_dense_bin = nb - n_moe_bin
        return (n_moe_bin * cfg.n_experts * 3 * d * cfg.moe_d_ff
                + n_dense_bin * 2 * d * cfg.d_ff)
    if cfg.family in ("dense", "vlm", "whisper"):
        return nb * 2 * d * cfg.d_ff
    if cfg.family == "mamba2_hybrid":
        di = cfg.expand * d
        return nb * (d * 2 * di + di * d)
    if cfg.family == "rwkv6":
        return nb * 2 * d * cfg.d_ff
    return 0.0


def activation_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    """Residual-stream + attention traffic per step (global, bf16)."""
    b = shape.global_batch
    decode = shape.kind == "decode"
    s = 1 if decode else shape.seq_len
    d = cfg.d_model
    # ~8 residual-stream-sized reads/writes per block (norm, attn io,
    # ffn io, residual adds)
    res = cfg.n_layers * 8 * b * s * d * 2.0
    if decode:
        res += kv_cache_bytes(cfg, shape)        # cache read (+ write 1 tok)
    elif cfg.family not in ("mamba2_hybrid", "rwkv6"):
        # chunked attention: each query chunk re-reads K,V
        n_chunks = max(s // cfg.attn_chunk, 1)
        dh = cfg.kv_head_dim()
        kv = (b * s * cfg.kv_lora_rank * 2.0 if cfg.use_mla
              else b * s * cfg.n_kv_heads * dh * 2 * 2.0)
        res += cfg.n_layers * n_chunks * kv
    return res


def kv_cache_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    b, t = shape.global_batch, shape.seq_len
    if cfg.family == "rwkv6":
        hd = cfg.head_dim or 64
        nh = cfg.d_model // hd
        return cfg.n_layers * b * (nh * hd * hd + 2 * cfg.d_model) * 4.0
    if cfg.family == "mamba2_hybrid":
        attn = (cfg.n_layers // cfg.attn_every) * _attn_kv_bytes(cfg, b, t)
        return cfg.n_layers * _mamba_state_bytes(cfg, b) + attn
    if cfg.use_mla:
        per = b * t * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2.0
        return cfg.n_layers * per
    return cfg.n_layers * _attn_kv_bytes(cfg, b, t)


def _attn_kv_bytes(cfg, b, t):
    """One attention layer's bf16 K and V over b x t."""
    return b * t * cfg.n_kv_heads * cfg.kv_head_dim() * 2 * 2.0


def _mamba_state_bytes(cfg, b):
    """One Mamba2 block's f32 SSM state and conv window over b rows."""
    di = cfg.expand * cfg.d_model
    return b * (di // 64 * 64 * cfg.d_state + (cfg.d_conv - 1) * (di + 2 * cfg.d_state)) * 4.0


def hbm_bytes(cfg: ModelConfig, shape: ShapeSpec) -> float:
    w = weight_bytes(cfg, deployed=shape.kind != "train")
    act = activation_bytes(cfg, shape)
    if shape.kind == "train":
        # fwd read + bwd read + grads write/read + optimizer (m, v rw + p rw)
        mdt = 2.0 if cfg.opt_moment_dtype == "bfloat16" else 4.0
        n = param_count(cfg)
        opt = n * (2 * 2.0 + 2 * 2 * mdt)       # p rw + m,v rw
        return 3 * w + opt + 3 * act
    return w + act
