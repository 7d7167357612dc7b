"""Deploy-time parameter transform: drop binary latents for quantized
weights (port of repro/models/deploy.py; paper Table II generalized to the
LM).

Representation per lowering mode, with the reference's keys:
  xnor -> ``w_packed``, the packed sign words (N, K/32) int32, 16x smaller
          than bf16 (the XNOR-popcount kernel, B1)
  int8 -> ``w_int8``, +-1 int8 (N, K), 2x smaller than bf16 (the plain int8
          product, core/binary_dense.binary_dense_apply_any)

The walk is structural: any dict with a ``w_latent`` leaf becomes a
quantized dict (its ``scale`` kept), through dicts and the per-layer list;
a binary MoE layer (a dict with ``s_mid``) has its expert stacks (E, K, N)
replaced by ``w_gate_q`` / ``w_up_q`` / ``w_down_q``: +-1 int8 (E, K, N),
or for xnor packed words (E, N, K/32). core/binary_dense.
binary_dense_apply_any and models/moe._expert_ffn read either, so the same
model code runs training and deployed params.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binarize import pack_bits, pack_signs_int8
from repro_torch.tree import map_binary_denses, map_binary_moe

EXPERT_STACKS = ("w_gate", "w_up", "w_down")

# deployed-param sharding rules (put before each family's PARAM_RULES:
# ModelApi.deployed_rules); packed dims shard like their latent
# counterparts (packed dim = K / 32)
DEPLOYED_RULES = [
    (r"ffn/bin_in/(w_packed|w_int8)$", ("mlp", "embed")),
    (r"ffn/bin_out/(w_packed|w_int8)$", ("embed", "mlp")),
    (r"(in_zx|c_k)/bin/(w_packed|w_int8)$", ("mlp", "embed")),
    (r"(out|c_v)/bin/(w_packed|w_int8)$", ("embed", "mlp")),
    (r"ffn/w_(gate|up)_q$", ("expert", None, "embed")),
    (r"ffn/w_down_q$", ("expert", "embed", None)),
]


def _quantize_dense(p: dict, mode: str) -> dict:
    w = p["w_latent"].T                            # (N, K): packing runs along K
    q = {"w_packed": pack_bits(w)} if mode == "xnor" else {"w_int8": pack_signs_int8(w)}
    if "scale" in p:
        q["scale"] = p["scale"]
    return q


def _quantize_expert_stack(w3, mode: str):
    """(E, K, N) latents -> (E, N, K/32) packed words or (E, K, N) int8."""
    return pack_bits(w3.transpose(-1, -2)) if mode == "xnor" else pack_signs_int8(w3)


def _deploy_moe(p: dict, mode: str) -> dict:
    """A binary MoE layer with its expert stacks quantized (``*_q``)."""
    out = {k: v for k, v in p.items() if k not in EXPERT_STACKS}
    out.update({k + "_q": _quantize_expert_stack(p[k], mode) for k in EXPERT_STACKS})
    return out


def deploy_params(params, cfg: ModelConfig):
    """Training params -> deployed params (latents, and any serving copy of
    the packed words beside them, dropped)."""
    mode = cfg.policy.binary_mode
    if mode == "bf16" or not cfg.policy.binary_ffn:
        return params
    params = map_binary_denses(lambda p: _quantize_dense(p, mode), params)
    return map_binary_moe(lambda p: _deploy_moe(p, mode), params)
