"""RWKV6 "Finch" block (port of repro/models/rwkv6.py): attention-free
time-mix with a data-dependent decay, w_t = exp(-exp(w0 + lora(x))), and a
recurrence over tokens whose state is one (hd x hd) matrix a head; the
channel-mix is the squared-relu FFN, which the precision policy binarizes
(``c_k`` / ``c_v`` as ``{"bin": <binary dense>}``, B2 on a card). The
time-mix projections and ``c_r`` stay float.

As in repro, ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` / ``w_o`` and ``c_r``
are applied at nn.dense_apply's default compute dtype, bf16, whatever
``cfg.compute_dtype`` says; ``gn`` is a layer norm over the whole d, not
per head. The WKV recurrence (a ``lax.scan`` over tokens in repro) is a
loop over tokens in plain torch on every device, a new f32 state each
step.

Tensor-parallel (a ``mixer`` split, launch/specs.serving_plan), by heads
as repro's rules place the leaves: a rank's columns of w_r / w_k / w_v /
w_g, w0 and u, and its heads' WKV state; the decay's low-rank product is
computed whole and sliced. y and g are gathered (exactly: one all_reduce
of zero-filled columns), gn runs over the whole y as on one device, and
the rank's output columns of w_o are gathered. The channel-mix's c_k /
c_v split as an FFN (``ffn``: c_v row-parallel, a binary one's int32 dot
summed before its cast), and the rank's columns of c_r gate its columns
of the summed c_v output before the gather. Every sum but a float c_v's
partials keeps one device's order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binary_dense import binary_dense_apply_any, binary_dense_init, with_packed
from repro_torch.models import lm_common as lc
from repro_torch.nn import layers as nn

DECAY_LORA = 64


def heads(cfg: ModelConfig) -> tuple[int, int]:
    """-> (heads, head dim): repro's ``head_dim or 64``."""
    hd = cfg.head_dim or 64
    return cfg.d_model // hd, hd


def rwkv_block_init(cfg: ModelConfig, *, binary: bool, generator, device,
                    packed: bool = True) -> dict:
    """repro's init distributions (not its numbers). ``packed``: add a
    binary block's serving copy of its sign words."""
    d, dff = cfg.d_model, cfg.d_ff
    kw = dict(generator=generator, device=device, dtype=lc.pdt(cfg))
    f32 = dict(generator=generator, device=device, dtype=torch.float32)
    p = {
        "ln1": nn.layernorm_init(d, device=device),
        "ln2": nn.layernorm_init(d, device=device),
        # time-mix
        "mu": torch.rand((5, d), **f32),                       # r, k, v, g, w
        "w_r": nn.dense_init(d, d, **kw),
        "w_k": nn.dense_init(d, d, **kw),
        "w_v": nn.dense_init(d, d, **kw),
        "w_g": nn.dense_init(d, d, **kw),
        "w_o": nn.dense_init(d, d, **kw),
        "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),
        "w_lora_a": torch.randn((d, DECAY_LORA), **f32) * 0.01,
        "w_lora_b": torch.randn((DECAY_LORA, d), **f32) * 0.01,
        "u": torch.randn((d,), **f32) * 0.1,                   # the bonus
        "gn": nn.layernorm_init(d, device=device),
    }
    # channel-mix
    p["mu_c"] = torch.rand((2, d), **f32)                      # k, r
    if binary:
        add = with_packed if packed else (lambda q: q)
        p["c_k"] = {"bin": add(binary_dense_init(d, dff, **kw))}
        p["c_v"] = {"bin": add(binary_dense_init(dff, d, **kw))}
    else:
        p["c_k"] = nn.dense_init(d, dff, **kw)
        p["c_v"] = nn.dense_init(dff, d, **kw)
    p["c_r"] = nn.dense_init(d, d, **kw)
    return p


def _dense_or_bin(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "bin" in p:
        return binary_dense_apply_any(p["bin"], x, mode=cfg.policy.binary_mode)
    return nn.dense_apply(p, x, compute_dtype=lc.cdt(cfg))


def _shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x (B, L, d), x_prev (B, 1, d) -> the x_{t-1} sequence."""
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _wkv_scan(r, k, v, w, u, nh: int, hd: int, state0):
    """The WKV recurrence: r, k, v, w (B, L, d) f32; state0 (B, nh, hd, hd).

    y_t = r_t . (S + u * k_t (x) v_t);  S' = diag(w_t) S + k_t (x) v_t
    -> (y (B, L, d), the final state). Each token's operands are views
    taken once, heads folded into the batch ((B nh, 1, hd) rows, (B nh,
    hd, 1) columns), so that a step is two bmm (the outer product, one
    exact product a term, and r_t's contraction, as einsum's) and four
    elementwise ops: what a dry run's fake trace pays per token."""
    b, length, d = r.shape

    def steps(t, shape):
        return t.reshape(b, length, nh, hd).transpose(1, 2).reshape(b * nh, length, *shape) \
            .unbind(1)
    uu = u.reshape(1, nh, hd, 1).expand(b, nh, hd, 1).reshape(b * nh, hd, 1)
    s, ys = state0.reshape(b * nh, hd, hd), []
    for r_t, k_t, v_t, w_t in zip(steps(r, (1, hd)), steps(k, (hd, 1)), steps(v, (1, hd)),
                                  steps(w, (hd, 1))):
        kv = torch.bmm(k_t, v_t)                                    # (B nh, hd, hd)
        ys.append(torch.bmm(r_t, s + uu * kv))
        s = w_t * s + kv
    y = torch.cat(ys, dim=1).reshape(b, nh, length, hd).transpose(1, 2).reshape(b, length, d)
    return y, s.reshape(b, nh, hd, hd)


def _columns(x: torch.Tensor, tp) -> torch.Tensor:
    """The rank's columns of a whole (..., d) tensor (``x`` itself where
    nothing is split)."""
    if tp is None:
        return x
    n = x.shape[-1] // tp.size
    return x[..., tp.rank * n:(tp.rank + 1) * n]


def time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, x_prev, state0):
    """x (B, L, d), normed -> (out, (the last x, the state))."""
    _, hd = heads(cfg)
    tp = lc.split_tp("mixer")
    xf = x.to(torch.float32)
    xs = _shift(xf, x_prev)

    def mix(i):
        return xf * p["mu"][i] + xs * (1 - p["mu"][i])
    cd = lc.cdt(cfg)
    r, k, v, g = (nn.dense_apply(p[name], mix(i).to(cd)).to(torch.float32)
                  for i, name in enumerate(("w_r", "w_k", "w_v", "w_g")))
    dd = _columns(torch.tanh(mix(4) @ p["w_lora_a"]) @ p["w_lora_b"], tp)
    w = torch.exp(-torch.exp(p["w0"] + dd))                       # (B, L, d) in (0, 1)
    y, sfin = _wkv_scan(r, k, v, w, p["u"], r.shape[-1] // hd, hd, state0)
    if tp is not None:
        y, g = tp.gather_last(torch.stack([y, g]))
    y = nn.layernorm_apply(p["gn"], y) * F.silu(g)
    out = nn.dense_apply(p["w_o"], y.to(cd))
    return (out if tp is None else tp.gather_last(out)), (xf[:, -1:], sfin)


def c_v(p: dict, k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The channel-mix's c_v over the squared relu: row-parallel where the
    FFN is split (a binary one's int32 dot summed before its cast)."""
    ffn = lc.split_tp("ffn")
    if ffn is None:
        return _dense_or_bin(p["c_v"], k, cfg)
    if "bin" in p["c_v"]:
        return binary_dense_apply_any(p["c_v"]["bin"], k, mode=cfg.policy.binary_mode,
                                      reduce=ffn.all_reduce)
    return lc.row_parallel(p["c_v"], k, cfg, ffn)


def channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, x_prev):
    """-> (out, the last x)."""
    xf = x.to(torch.float32)
    xs = _shift(xf, x_prev)
    xk = xf * p["mu_c"][0] + xs * (1 - p["mu_c"][0])
    xr = xf * p["mu_c"][1] + xs * (1 - p["mu_c"][1])
    cd = lc.cdt(cfg)
    k = torch.square(F.relu(_dense_or_bin(p["c_k"], xk.to(cd), cfg).to(torch.float32)))
    kv = c_v(p, k.to(cd), cfg)
    r = torch.sigmoid(nn.dense_apply(p["c_r"], xr.to(cd)).to(torch.float32))
    tp = lc.split_tp("mixer")
    out = (r * _columns(kv.to(torch.float32), tp)).to(x.dtype)
    return (out if tp is None else tp.gather_last(out)), xf[:, -1:]


def rwkv_block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict | None = None):
    """cache {"tm_x", "tm_s", "cm_x"}, or None for zeros -> (x, the new
    cache)."""
    if cache is None:
        cache = rwkv_init_cache_block(cfg, x.shape[0], device=x.device)
    tm, (tm_x, tm_s) = time_mix(p, nn.layernorm_apply(p["ln1"], x), cfg, cache["tm_x"],
                                cache["tm_s"])
    x = x + tm.to(x.dtype)
    cm, cm_x = channel_mix(p, nn.layernorm_apply(p["ln2"], x), cfg, cache["cm_x"])
    return x + cm.to(x.dtype), {"tm_x": tm_x, "tm_s": tm_s, "cm_x": cm_x}


def rwkv_init_cache_block(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zero state: the WKV state of the rank's heads (all of them on one
    device), the token-shift rows whole."""
    nh, hd = heads(cfg)
    tp = lc.split_tp("mixer")
    nh = nh if tp is None else nh // tp.size
    f32 = dict(dtype=torch.float32, device=device)
    return {"tm_x": torch.zeros((batch, 1, cfg.d_model), **f32),
            "tm_s": torch.zeros((batch, nh, hd, hd), **f32),
            "cm_x": torch.zeros((batch, 1, cfg.d_model), **f32)}
