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
    -> (y (B, L, d), the final state)."""
    b, length, d = r.shape
    rr, kk, vv, ww = (t.reshape(b, length, nh, hd) for t in (r, k, v, w))
    uu = u.reshape(nh, hd)[:, :, None]
    s, ys = state0, []
    for t in range(length):
        kv = kk[:, t, :, :, None] * vv[:, t, :, None, :]           # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", rr[:, t], s + uu * kv))
        s = ww[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1).reshape(b, length, d), s


def time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, x_prev, state0):
    """x (B, L, d), normed -> (out, (the last x, the state))."""
    nh, hd = heads(cfg)
    xf = x.to(torch.float32)
    xs = _shift(xf, x_prev)

    def mix(i):
        return xf * p["mu"][i] + xs * (1 - p["mu"][i])
    cd = lc.cdt(cfg)
    r, k, v, g = (nn.dense_apply(p[name], mix(i).to(cd)).to(torch.float32)
                  for i, name in enumerate(("w_r", "w_k", "w_v", "w_g")))
    dd = torch.tanh(mix(4) @ p["w_lora_a"]) @ p["w_lora_b"]
    w = torch.exp(-torch.exp(p["w0"] + dd))                       # (B, L, d) in (0, 1)
    y, sfin = _wkv_scan(r, k, v, w, p["u"], nh, hd, state0)
    y = nn.layernorm_apply(p["gn"], y) * F.silu(g)
    return nn.dense_apply(p["w_o"], y.to(cd)), (xf[:, -1:], sfin)


def channel_mix(p: dict, x: torch.Tensor, cfg: ModelConfig, x_prev):
    """-> (out, the last x)."""
    xf = x.to(torch.float32)
    xs = _shift(xf, x_prev)
    xk = xf * p["mu_c"][0] + xs * (1 - p["mu_c"][0])
    xr = xf * p["mu_c"][1] + xs * (1 - p["mu_c"][1])
    cd = lc.cdt(cfg)
    k = torch.square(F.relu(_dense_or_bin(p["c_k"], xk.to(cd), cfg).to(torch.float32)))
    kv = _dense_or_bin(p["c_v"], k.to(cd), cfg).to(torch.float32)
    r = torch.sigmoid(nn.dense_apply(p["c_r"], xr.to(cd)).to(torch.float32))
    return (r * kv).to(x.dtype), xf[:, -1:]


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
    nh, hd = heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"tm_x": torch.zeros((batch, 1, cfg.d_model), **f32),
            "tm_s": torch.zeros((batch, nh, hd, hd), **f32),
            "cm_x": torch.zeros((batch, 1, cfg.d_model), **f32)}
