"""Roofline terms of one step on one card (port of
repro/distributed/hlo_analysis.py, under its name so that a reader finds
the counterpart).

repro reads a compiled SPMD module: ``cost_analysis()`` for per-partition
FLOPs and bytes, and the post-partitioning HLO text for collective bytes.
Torch produces no HLO, so the HLO-text parsers (``_array_bytes``,
``_split_computations``, ``collective_bytes``,
``collective_bytes_while_aware``) are not ported. Their job, the
collective bytes of one compiled step, is done by the recorder of
distributed/collectives.py, which the dry run (launch/dryrun.py) runs the
step under: every collective the port issues passes its entry point, so
the record is exact by construction and needs no loop trip counts.
``analyze_step`` takes the dry run's record where ``analyze_compiled``
took a compiled executable, and gives the same layout.

Per-card constants of the card the port runs on, an NVIDIA H100 SXM5 80GB
HBM3 at 700 W. Each is a datasheet figure, not a measurement.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# --- NVIDIA H100 SXM5 per-card constants (datasheet, dense) ---
PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores
PEAK_INT8 = 1979e12         # OP/s, int8 tensor cores
HBM_BW = 3.35e12            # B/s, HBM3
NVLINK_BW = 450e9           # B/s a direction a card, NVLink 4 (18 links)
NIC_BW = 50e9               # B/s, one 400 Gb/s NIC a card
# the link each mesh axis's collectives cross: ``model`` stays inside one
# node's NVLink domain (launch/mesh.NVLINK_DOMAIN cards), ``data`` spans
# the nodes through their NICs. Unknown axes get the slower link.
AXIS_BW = {"model": NVLINK_BW, "data": NIC_BW}


def t_collective(bytes_by_axis: dict) -> float:
    """Seconds to move each axis's collective bytes over its own link, one
    axis after another (repro's single ICI_LINKS x ICI_BW has no
    counterpart on a node of 8 cards)."""
    return sum(b / AXIS_BW.get(axis, NIC_BW) for axis, b in bytes_by_axis.items())


@dataclass
class Roofline:
    flops: float                 # per-device flops
    hbm_bytes: float             # per-device bytes accessed
    coll_bytes: float            # per-device collective bytes
    # per-device collective bytes by mesh axis; None: all over the NIC
    coll_by_axis: dict | None = None
    # seconds of compute; None: every flop at PEAK_BF16 (analyze_step
    # passes the analytic buckets' time, each bucket at its own peak)
    t_compute: float | None = None
    t_memory: float = field(init=False)
    t_collective: float = field(init=False)
    bottleneck: str = field(init=False)

    def __post_init__(self):
        if self.t_compute is None:
            self.t_compute = self.flops / PEAK_BF16
        self.t_memory = self.hbm_bytes / HBM_BW
        by_axis = self.coll_by_axis if self.coll_by_axis is not None else \
            {"data": self.coll_bytes}
        self.t_collective = t_collective(by_axis)
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)

    def as_dict(self):
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_est": max(self.t_compute, self.t_memory, self.t_collective),
        }


def _other_part_cost(cfg, shape, part: str, per_param: float):
    """_part_cost's ``attn`` and ``mixer`` of whisper, the VLM and the
    recurrent families, from analytic_cost's per-layer terms: whisper's
    encoder, decoder and cross attention, the VLM's self and cross
    attention, zamba2's shared block's invocations (one set of weights),
    the Mamba2 blocks or RWKV6's products over heads (``mixer``: their
    products, weights and state)."""
    from repro_torch.distributed import analytic_cost as AC
    b, decode = shape.global_batch, shape.kind == "decode"
    s, t, L = 1 if decode else shape.seq_len, shape.seq_len, cfg.n_layers
    cost = AC.StepCost()
    if part == "mixer" and cfg.family == "mamba2_hybrid":
        for i in range(L):
            cost.add(AC._mamba(cfg, b, s, binary=cfg.policy.block_is_binary(i, L),
                               decode=decode))
        cost.hbm_bytes = L * _mamba_params(cfg) * per_param
        if decode:
            cost.hbm_bytes += L * AC._mamba_state_bytes(cfg, b)
        return cost
    if part == "mixer" and cfg.family == "rwkv6":
        for _ in range(L):
            cost.add(AC._rwkv_mix(cfg, b, s))
        cost.hbm_bytes = L * _rwkv_mix_params(cfg) * per_param
        if decode:
            cost.hbm_bytes += AC.kv_cache_bytes(cfg, shape)
        return cost
    if part != "attn" or cfg.family not in ("whisper", "vlm", "mamba2_hybrid"):
        raise ValueError(f"no analytic cost of {cfg.name!r}'s {part!r} kept whole")
    if cfg.family == "whisper":
        te, layers, calls = cfg.n_audio_frames, cfg.enc_layers + 2 * L, L
        if not decode:
            for _ in range(cfg.enc_layers):
                cost.add(AC._attn_gqa(cfg, b, te, te, causal=False))
        for _ in range(L):
            cost.add(AC._attn_gqa(cfg, b, s, t, causal=not decode))
            cost.add(AC._cross_attn(cfg, b, s, te, kv=not decode))
    elif cfg.family == "vlm":
        n_cross = L // cfg.cross_every
        layers, calls = L + n_cross, L
        for _ in range(L):
            cost.add(AC._attn_gqa(cfg, b, s, t, causal=not decode))
        for _ in range(n_cross):
            cost.add(AC._cross_attn(cfg, b, s, cfg.n_patches))
    else:
        layers, calls = 1, L // cfg.attn_every    # zamba2: one shared block, invoked L // attn_every
        for _ in range(calls):
            cost.add(AC._attn_gqa(cfg, b, s, t, causal=not decode))
    cost.hbm_bytes = layers * _attn_params(cfg) * per_param
    if decode:
        cost.hbm_bytes += calls * AC._attn_kv_bytes(cfg, b, t)
    return cost


def _part_cost(cfg, shape, part: str):
    """The global analytic cost of one part of a model's step
    (analytic_cost's terms for it): ``attn`` (projections, scores, the KV
    cache or its chunked re-reads), ``mla_whole`` (what MLA keeps whole
    where its heads split: the down projections and the compressed
    cache), ``ffn`` (the dense FFNs and the MoE layers' shared experts),
    ``router`` (its products) or ``vocab`` (the head's product, the
    embedding and head weights); ``mixer``, and ``attn`` of the other
    families: _other_part_cost."""
    from repro_torch.distributed import analytic_cost as AC
    b, train, decode = shape.global_batch, shape.kind == "train", shape.kind == "decode"
    s = 1 if decode else shape.seq_len
    d, L = cfg.d_model, cfg.n_layers
    # bytes a parameter moves: bf16 reads (x3 in a train step: forward,
    # backward, grads) and, in training, AdamW's p / m / v traffic
    mdt = 2.0 if cfg.opt_moment_dtype == "bfloat16" else 4.0
    per_param = 3 * 2.0 + 2 * 2.0 + 2 * 2 * mdt if train else 2.0
    moe_layers = [i for i in range(L) if cfg.family == "moe" and i >= cfg.first_dense_layers]
    binary = [cfg.policy.block_is_binary(i, L) for i in range(L)]
    qc, c, dr = cfg.q_lora_rank, cfg.kv_lora_rank, cfg.qk_rope_dim

    def mla_cache_bytes():
        if decode:
            return AC.kv_cache_bytes(cfg, shape)
        return (3 if train else 1) * L * max(s // cfg.attn_chunk, 1) * b * s * c * 2.0
    cost = AC.StepCost()
    if part == "mixer" or (part == "attn" and cfg.family not in ("dense", "moe")):
        cost = _other_part_cost(cfg, shape, part, per_param)
    elif part == "ffn" and cfg.family not in ("dense", "moe"):
        raise ValueError(f"no analytic cost of {cfg.name!r}'s FFNs kept whole")
    elif part == "attn" and cfg.use_mla:
        for _ in range(L):
            cost.add(AC._attn_mla(cfg, b, s, shape.seq_len, decode=decode))
        h, dn, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
        qp = d * qc + qc * h * (dn + dr) if qc else d * h * (dn + dr)
        cost.hbm_bytes = (L * (qp + d * (c + dr) + c * h * (dn + dv) + h * dv * d) * per_param
                          + mla_cache_bytes())
    elif part == "attn":
        for _ in range(L):
            cost.add(AC._attn_gqa(cfg, b, s, shape.seq_len, causal=not decode))
        cost.hbm_bytes = L * _attn_params(cfg) * per_param
        if decode:
            cost.hbm_bytes += AC.kv_cache_bytes(cfg, shape)
        else:
            kv = b * s * cfg.n_kv_heads * cfg.kv_head_dim() * 2 * 2.0
            cost.hbm_bytes += (3 if train else 1) * L * max(s // cfg.attn_chunk, 1) * kv
    elif part == "mla_whole":
        cost.flops_bf16 = L * 2 * b * s * d * (qc + c + dr)
        cost.hbm_bytes = L * d * (qc + c + dr) * per_param + mla_cache_bytes()
    elif part == "ffn":
        dense = [i for i in range(L) if i not in moe_layers]
        for i in dense:
            cost.add(AC._ffn(cfg, b * s, binary=binary[i]))
        shared = cfg.n_shared_experts * cfg.moe_d_ff
        cost.flops_bf16 += len(moe_layers) * 2 * b * s * d * shared * 3
        n = len(dense) * 3 * d * cfg.d_ff
        nb = sum(binary[i] for i in dense) * 2 * d * cfg.d_ff
        if not train and cfg.policy.binary_ffn and cfg.policy.binary_mode != "bf16":
            per = 0.125 if cfg.policy.binary_mode == "xnor" else 1.0
            cost.hbm_bytes = (n - nb) * 2.0 + nb * per
        else:
            cost.hbm_bytes = n * per_param
        cost.hbm_bytes += len(moe_layers) * 3 * d * shared * per_param
    elif part == "router":
        cost.flops_bf16 = len(moe_layers) * 2 * b * s * d * cfg.n_experts
    elif part == "vocab":
        cost.add(AC._head(cfg, b * s if train else b))
        cost.hbm_bytes = cfg.vocab * d * (1 if cfg.tie_embeddings else 2) * per_param
    else:
        raise ValueError(part)
    if train:
        k = AC.REMAT_FACTOR.get(cfg.remat, 4.0)
        cost = AC.StepCost(cost.flops_bf16 * k, cost.flops_int8 * k, cost.flops_xnor * k,
                           cost.hbm_bytes)
    return cost


def card_cost(cfg, shape, *, data: int, model: int, split: dict):
    """One card's share of the step's analytic cost (analytic_cost.StepCost:
    FLOPs by bucket, HBM bytes). repro divides the global cost by the card
    count, as GSPMD splits every part. Here a rank holds 1 / ``data`` of
    the rows; a part that the ``model`` axis splits (``split``: {"attn",
    "ffn", "vocab", "mixer"} -> bool, the plan's; a MoE layer's routed
    experts always split) is 1 / ``model`` of that, but a part it keeps
    whole (attention where the cache heads cannot split; MLA's down
    projections and compressed cache; a MoE layer's router; a recurrent
    family's mixer where its heads cannot split) is computed and read
    whole by every rank of the axis.
    The rest (the residual stream, norms) is divided by the card count, as
    repro's."""
    from repro_torch.distributed import analytic_cost as AC
    total, n = AC.step_cost(cfg, shape), data * model
    parts = [p for p in ("attn", "ffn", "vocab") if p != "attn" or cfg.family != "rwkv6"]
    if cfg.family in ("mamba2_hybrid", "rwkv6"):
        parts.append("mixer")
    whole = [p for p in parts if not split.get(p, False)]
    if cfg.n_experts:
        whole.append("router")       # the routed experts always split (_model_split)
    if cfg.use_mla and split["attn"]:
        whole.append("mla_whole")
    if model == 1 or not whole:
        return total.scaled(1 / n)
    rep = AC.StepCost()
    for p in whole:
        rep.add(_part_cost(cfg, shape, p))
    return AC.StepCost(*((t - r) / n + r / data for t, r in (
        (total.flops_bf16, rep.flops_bf16), (total.flops_int8, rep.flops_int8),
        (total.flops_xnor, rep.flops_xnor), (total.hbm_bytes, rep.hbm_bytes))))


def analyze_step(record: dict, *, cfg, shape, data: int, model: int, split: dict) -> dict:
    """The dry run's record of one rank's step -> repro's layout of
    ``analyze_compiled``: ``cost`` (``flops_counted`` from FlopCounterMode
    where repro has ``flops_hlo_body_once``), ``collectives`` (the
    recorder's, repro's keys), ``memory``, ``analytic`` (the global step's
    buckets) and ``roofline`` (a Roofline of one card's share, card_cost,
    each FLOP bucket at its own peak, and the recorder's bytes per axis
    over that axis's link; repro's uses the analytic model and the
    while-aware HLO bytes). ``data``: the ways the global batch's rows
    are split; ``model`` and ``split``: the ``model`` axis's size and the
    plan's parts on it (card_cost)."""
    from repro_torch.distributed import analytic_cost as AC
    coll = record["collectives"]
    sc = AC.step_cost(cfg, shape)
    card = card_cost(cfg, shape, data=data, model=model, split=split)
    rl = Roofline(card.flops_total, card.hbm_bytes, coll["total_bytes"],
                  {a: v["bytes"] for a, v in coll.get("by_axis", {}).items()},
                  t_compute=card.t_compute(1))
    return {
        "cost": {"flops_counted": record["flops_counted"]},
        "collectives": coll,
        "memory": record["memory"],
        "analytic": {
            "flops_bf16": sc.flops_bf16, "flops_int8": sc.flops_int8,
            "flops_xnor": sc.flops_xnor, "hbm_bytes": sc.hbm_bytes,
        },
        "roofline": rl.as_dict(),
    }


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE) for the step's
    token count D; decode steps process one token per sequence."""
    n = param_count(cfg, active_only=True)
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n * d
    d = shape.global_batch          # decode: one token per sequence
    return 2.0 * n * d


def param_count(cfg, *, active_only: bool = False) -> float:
    """Analytic parameter count (embeddings + blocks + head)."""
    d, v, L = cfg.d_model, cfg.vocab, cfg.n_layers
    emb = v * d * (1 if cfg.tie_embeddings else 2)
    per_block = 0.0
    if cfg.family in ("dense", "moe", "vlm"):
        if cfg.use_mla:
            h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                             cfg.v_head_dim)
            c, qc = cfg.kv_lora_rank, cfg.q_lora_rank
            attn = (d * qc + qc * h * (dn + dr)) if qc else \
                d * h * (dn + dr)
            attn += d * (c + dr) + c * h * dn + c * h * dv + h * dv * d
        else:
            attn = _attn_params(cfg)
        per_block = attn
    if cfg.family == "moe":
        dense_ffn = 3 * d * cfg.d_ff
        routed_all = cfg.n_experts * 3 * d * cfg.moe_d_ff
        routed_act = cfg.top_k * 3 * d * cfg.moe_d_ff
        shared = cfg.n_shared_experts * 3 * d * cfg.moe_d_ff
        n_moe = L - cfg.first_dense_layers
        total = (emb + L * per_block + cfg.first_dense_layers * dense_ffn
                 + n_moe * ((routed_act if active_only else routed_all)
                            + shared))
        return total
    if cfg.family in ("dense", "vlm"):
        ffn = 3 * d * cfg.d_ff
        total = emb + L * (per_block + ffn)
        if cfg.family == "vlm":
            n_cross = L // cfg.cross_every
            cross = _attn_params(cfg) + 3 * d * cfg.d_ff
            total += n_cross * cross
        return total
    if cfg.family == "whisper":
        attn = 4 * d * d
        ffn = 2 * d * cfg.d_ff
        enc = cfg.enc_layers * (attn + ffn)
        dec = L * (2 * attn + ffn)
        return emb + enc + dec
    if cfg.family == "mamba2_hybrid":
        shared = 4 * d * d + 3 * d * cfg.d_ff
        return emb + L * _mamba_params(cfg) + shared
    if cfg.family == "rwkv6":
        return emb + L * (_rwkv_mix_params(cfg) + 2 * d * cfg.d_ff)
    raise ValueError(cfg.family)


def _attn_params(cfg) -> int:
    """One GQA attention layer's q, k, v and o weights."""
    d = cfg.d_model
    dh = cfg.head_dim or d // cfg.n_heads
    return d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)


def _mamba_params(cfg) -> int:
    """One Mamba2 block's in_zx, in_bcdt and out weights."""
    d, di = cfg.d_model, cfg.expand * cfg.d_model
    return d * 2 * di + d * (2 * cfg.d_state + di // 64) + di * d


def _rwkv_mix_params(cfg) -> int:
    """One RWKV6 block's weights over its heads: the time-mix's five
    projections and decay LoRA, and the channel-mix's c_r."""
    d = cfg.d_model
    return 5 * d * d + 2 * d * 64 + d * d
