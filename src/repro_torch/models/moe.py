"""Mixture-of-Experts layer, DeepSeek V2/V3 style (port of
repro/models/moe.py).

Dispatch sorts the (token, expert) pairs by expert, keeps the first
``capacity`` of each expert (GShard-style: the overflow is dropped),
gathers the kept tokens into an (E, C, d) buffer, runs the experts as
batched products, and combines each token's gated expert rows. The expert
weights are stacks (E, K, N).

On a ``model`` mesh (``TensorParallel.experts``, the reference's
``expert`` axis) a rank holds E / N whole experts (its ``*`` / ``*_q``
stacks, ``s_mid``, ``s_out``). The tokens are replicated over the axis,
so routing, the capacity (from the global token count) and the dispatch
table are computed whole and alike on every rank; a rank gathers and runs
only its experts' slots, builds the gated pair rows of its pairs (zeros
for the others') and ``gather_pairs`` sums them over the axis. Each pair
is one rank's, so the sum is exact and the fixed-order combine then runs
on one device's bits: a binary MoE layer's routed output equals one
device's bit for bit. The shared experts split as a float FFN (``ffn``):
column-parallel, their down product row-parallel, added after the routed
sum, as on one device.

Binary experts: the paper's technique where it pays most. The routed
expert stacks are most of an MoE model's bytes; the router, the shared
experts and the edge blocks stay float (the paper's edge-layer rule).
Their products are kernels/ops.binary_dense_batched (latents, STE) or
binary_dense_batched_deployed (the ``*_q`` stacks of models/deploy.py),
plain torch as the reference's XLA batched dots.

What the card needs, beside the reference's semantics:
  * the sort is stable (``jnp.argsort`` is; torch's is only when asked), so
    capacity drops pick the same tokens;
  * the combine is deterministic: each token sums its k gathered rows in
    one fixed order, where a scatter-add (``index_add_``) would race in
    atomics, and a replayed decode tick could then differ from the eager
    one;
  * no host sync: the capacity is a host integer from the shapes, so the
    dispatch runs inside a captured decode tick.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.nn import layers as nn


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8, floor 8


def moe_init(cfg: ModelConfig, *, binary: bool, generator, device) -> dict:
    """repro's moe_init distributions (not its numbers): binary latents
    U(-1, 1), float stacks N(0, 1/fan_in), the router N(0, 0.02^2) in f32."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    pdt = getattr(torch, cfg.param_dtype)

    def expert_stack(din, dout):
        if binary:
            w = torch.rand((e, din, dout), generator=generator, device=device) * 2 - 1
        else:
            w = torch.randn((e, din, dout), generator=generator, device=device) * din ** -0.5
        return w.to(pdt)

    p = {"router": {"w": torch.randn((d, e), generator=generator, device=device) * 0.02},
         "w_gate": expert_stack(d, f), "w_up": expert_stack(d, f),
         "w_down": expert_stack(f, d)}
    if binary:
        # per-expert per-channel output scales (a stability adaptation)
        p["s_mid"] = torch.full((e, f), d ** -0.5, dtype=torch.float32, device=device)
        p["s_out"] = torch.full((e, d), f ** -0.5, dtype=torch.float32, device=device)
    if cfg.router_type == "sigmoid":
        p["router"]["bias"] = torch.zeros((e,), dtype=torch.float32, device=device)
    if cfg.n_shared_experts:
        p["shared"] = nn.swiglu_init(d, cfg.n_shared_experts * f, generator=generator,
                                     device=device, dtype=pdt)
    return p


def _route(p: dict, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d (T, d) -> (gates (T, k), idx (T, k), aux loss), all in f32."""
    scores = x2d.to(torch.float32) @ p["router"]["w"]
    if cfg.router_type == "sigmoid":
        s = torch.sigmoid(scores)
        _, idx = torch.topk(s + p["router"]["bias"][None, :], cfg.top_k, dim=-1)
        gates = torch.gather(s, 1, idx)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        aux = scores.new_zeros(())       # aux-free (the optimizer moves the bias)
    else:
        probs = torch.softmax(scores, dim=-1)
        gates, idx = torch.topk(probs, cfg.top_k, dim=-1)
        gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
        # load-balance loss (Switch): E * sum_e f_e * p_e
        e = cfg.n_experts
        f_e = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)
        aux = e * torch.sum(f_e * probs.mean(0))
    return gates, idx, aux


def _expert_ffn(p: dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe (E, C, d) -> (E, C, d): the grouped SwiGLU, float or binary
    (training latents, or the deployed ``*_q`` stacks, by key)."""
    if "s_mid" in p:
        if "w_gate_q" in p:
            def bd(x3, name):
                return ops.binary_dense_batched_deployed(x3, p[name + "_q"])
        else:
            def bd(x3, name):
                return ops.binary_dense_batched(x3, p[name])
        s_mid = p["s_mid"][:, None, :]
        h = F.silu(bd(xe, "w_gate") * s_mid) * (bd(xe, "w_up") * s_mid)
        return (bd(h, "w_down") * p["s_out"][:, None, :]).to(xe.dtype)
    cdt = getattr(torch, cfg.compute_dtype)
    xe = xe.to(cdt)
    g = torch.bmm(xe, p["w_gate"].to(cdt))
    u = torch.bmm(xe, p["w_up"].to(cdt))
    h = F.silu(g.to(torch.float32)).to(cdt) * u
    return torch.bmm(h, p["w_down"].to(cdt))


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) -> (y (B, S, d), aux loss); on a mesh, this rank's
    experts' share of the dispatch (module note)."""
    from repro_torch.models.lm_common import row_parallel, split_tp
    b, s, d = x.shape
    t = b * s
    x2d = x.reshape(t, d)
    gates, idx, aux = _route(p, x2d, cfg)
    k, e = cfg.top_k, cfg.n_experts
    cap = _capacity(t, cfg)
    dev = x.device

    # dispatch table: the (token, expert) pairs sorted by expert, stably
    e_flat = idx.reshape(-1)                                        # (T k,)
    t_flat = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    seg_start = torch.searchsorted(e_sorted, torch.arange(e, device=dev))
    pos_in_e = torch.arange(t * k, device=dev) - seg_start[e_sorted]
    keep = pos_in_e < cap                                           # capacity drop
    slot = torch.where(keep, e_sorted * cap + pos_in_e, e * cap)    # overflow: sentinel

    # slot -> token (token t, a zero row, for an empty slot; the sentinel
    # slot at the end takes every dropped pair and is cut off)
    tok_for_slot = torch.full((e * cap + 1,), t, dtype=torch.int64, device=dev)
    tok_for_slot = tok_for_slot.index_put((slot,), t_flat[order])[:-1]
    # on a mesh: this rank's experts' slots, lo .. lo + n_slots - 1
    tp = split_tp("experts")
    n_slots = e * cap if tp is None else e // tp.size * cap
    lo = 0 if tp is None else tp.rank * n_slots
    x_pad = torch.cat([x2d, x2d.new_zeros((1, d))], dim=0)
    xe = x_pad[tok_for_slot[lo:lo + n_slots]].reshape(-1, cap, d)
    ye = _expert_ffn(p, xe if tp is None else tp.copy(xe), cfg).reshape(n_slots, d)

    # combine: pair (token, j) reads its slot's row (the zero row when
    # dropped, or another rank's), times its gate in ye's dtype, and each
    # token sums its k rows
    slot_of_pair = torch.empty_like(slot).index_put((order,), slot) - lo
    gate_of_pair = torch.where(keep, gates.reshape(-1)[order], 0.0)
    gate_of_pair = torch.empty_like(gate_of_pair).index_put((order,), gate_of_pair)
    mine = (slot_of_pair >= 0) & (slot_of_pair < n_slots)
    ye_pad = torch.cat([ye, ye.new_zeros((1, d))], dim=0)
    rows = ye_pad[torch.where(mine, slot_of_pair, n_slots)] * gate_of_pair[:, None].to(ye.dtype)
    if tp is not None:
        rows = tp.gather_pairs(rows, mine)
    y = rows.reshape(t, k, d).sum(1)

    if "shared" in p:
        cd = getattr(torch, cfg.compute_dtype)
        tp = split_tp("ffn")
        if tp is None:
            y = y + nn.swiglu_apply(p["shared"], x2d, compute_dtype=cd)
        else:
            y = y + nn.swiglu_apply(p["shared"], tp.copy(x2d), compute_dtype=cd,
                                    down=lambda pd, h: row_parallel(pd, h, cfg, tp))
    return y.reshape(b, s, d).to(x.dtype), aux
