"""Mamba2 (SSD) block (port of repro/models/mamba2.py): the chunked
state-space duality algorithm for training and prefill, an O(1) recurrent
state update for decode.

The in-projection is split so that the precision policy can binarize the
channel-mixing path (z, x) without touching the SSM dynamics (B, C, dt):
a binary block holds ``in_zx`` and ``out`` as ``{"bin": <binary dense>}``,
which run B2 on a card (core/binary_dense.binary_dense_apply_any), while
``in_bcdt``, the causal conv and the state stay f32.

The sequence mixing (the conv, the SSD's intra-chunk products and its
carry over chunks) is plain torch on every device: the reference computes
it in XLA, not in a Pallas kernel. The carry, a ``lax.scan`` in repro, is
a loop over the chunks here.

Tensor-parallel (a ``mixer`` split, launch/specs.serving_plan): a rank
holds its heads' columns of each half of ``in_zx`` and their conv
channels beside B and C whole (MeshRules.cuts), the whole ``in_bcdt``
(its dt columns, a_log, d_skip and dt_bias are sliced to the rank's
heads here), its heads' state, its width of ``gnorm`` (the mean square
summed over the ranks, TensorParallel.sum_last: only its magnitude's
rounding can differ, never the sign a binary ``out`` reads) and its rows
of ``out``, which is row-parallel (a binary one's int32 dot summed before
its cast, bit for bit).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binary_dense import binary_dense_apply_any, binary_dense_init, with_packed
from repro_torch.models import lm_common as lc
from repro_torch.nn import layers as nn

HEAD_P = 64  # mamba2 head dim


def dims(cfg: ModelConfig) -> tuple[int, int]:
    di = cfg.expand * cfg.d_model
    return di, di // HEAD_P


def local_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """-> (inner width, heads, the first head) this rank holds: all of them
    unless the ``mixer`` is split."""
    di, nh = dims(cfg)
    tp = lc.split_tp("mixer")
    if tp is None:
        return di, nh, 0
    return di // tp.size, nh // tp.size, tp.rank * (nh // tp.size)


def mesh_cuts(cfg: ModelConfig, split: bool, block: str) -> list:
    """MeshRules.cuts of the Mamba2 blocks' leaves (paths matching
    ``block``, a regex ending where a block's leaf names begin) and of
    their state. Split by heads: a contiguous cut of the packed [z | x]
    (``in_zx``, 2 di wide) would give rank 0 all of z, so each half is cut
    by heads; the conv channels [x | B | C] (``conv_w``, ``conv_b`` and the
    ``conv`` state) keep B and C whole, as every head reads them
    (n_groups = 1). Not split: every leaf and the state whole."""
    if not split:
        return [(block + r"(in_zx|out|gnorm|conv_w|conv_b)(/|$)", ()),
                (r"(^|/)(h|conv)$", ())]
    di, ds = dims(cfg)[0], cfg.d_state
    return [(r"(^|/)in_zx/", ((di, True), (di, True))),
            (r"(^|/)(conv_w|conv_b|conv)$", ((di, True), (2 * ds, False)))]


def mamba_init(cfg: ModelConfig, *, binary: bool, generator, device,
               packed: bool = True) -> dict:
    """repro's init distributions (not its numbers); a_log, d_skip and
    dt_bias are its constants. ``packed``: add a binary block's serving
    copy of its sign words (the trainer holds latents only)."""
    d, ds = cfg.d_model, cfg.d_state
    di, nh = dims(cfg)
    kw = dict(generator=generator, device=device, dtype=lc.pdt(cfg))
    if binary:
        add = with_packed if packed else (lambda p: p)
        in_zx = {"bin": add(binary_dense_init(d, 2 * di, **kw))}
        out_dense = {"bin": add(binary_dense_init(di, d, **kw))}
    else:
        in_zx = nn.dense_init(d, 2 * di, **kw)
        out_dense = nn.dense_init(di, d, **kw)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": nn.rmsnorm_init(d, device=device),
        "in_zx": in_zx,
        "in_bcdt": nn.dense_init(d, 2 * ds + nh, generator=generator, device=device,
                                 dtype=torch.float32),
        "conv_w": torch.randn((cfg.d_conv, di + 2 * ds), generator=generator, **f32) * 0.2,
        "conv_b": torch.zeros((di + 2 * ds,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "d_skip": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "gnorm": nn.rmsnorm_init(di, device=device),
        "out": out_dense,
    }


def _dense_or_bin(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if "bin" in p:
        return binary_dense_apply_any(p["bin"], x, mode=cfg.policy.binary_mode)
    return nn.dense_apply(p, x, compute_dtype=lc.cdt(cfg))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in f32: u (B, L, C), w (W, C) -> (B, L, C),
    the taps summed in repro's order."""
    wlen, length = w.shape[0], u.shape[1]
    uf = u.to(torch.float32)
    out = torch.zeros_like(uf)
    for i in range(wlen):
        ui = F.pad(uf, (0, 0, wlen - 1 - i, 0))[:, :length]
        out = out + ui * w[i]
    return out + b


def _split_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Both projections -> z, the conv's input [x | B | C] in f32 (also the
    decode cache's window), dt before its softplus: the rank's heads'."""
    ds = cfg.d_state
    di, nh, h0 = local_dims(cfg)
    zx = _dense_or_bin(p["in_zx"], x, cfg)
    z, xin = zx[..., :di], zx[..., di:]
    bcdt = nn.dense_apply(p["in_bcdt"], x, compute_dtype=torch.float32)
    conv_in = torch.cat([xin.to(torch.float32), bcdt[..., :2 * ds]], dim=-1)
    return z, conv_in, bcdt[..., 2 * ds + h0:2 * ds + h0 + nh]


def _post_conv(conv_out: torch.Tensor, cfg: ModelConfig):
    ds = cfg.d_state
    di, _, _ = local_dims(cfg)
    conv_out = F.silu(conv_out)
    return conv_out[..., :di], conv_out[..., di:di + ds], conv_out[..., di + ds:]


def _heads(p: dict, cfg: ModelConfig):
    """(a_log, d_skip, dt_bias) of the rank's heads."""
    _, nh, h0 = local_dims(cfg)
    return (p[k][h0:h0 + nh] for k in ("a_log", "d_skip", "dt_bias"))


def _gnorm(p: dict, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """gnorm, an RMS norm over all of di: where the mixer is split, the
    mean square is the ranks' partial sums over their widths, summed."""
    tp = lc.split_tp("mixer")
    if tp is None:
        return nn.rmsnorm_apply(p["gnorm"], y)
    yf = y.to(torch.float32)
    var = tp.sum_last(yf * yf) / dims(cfg)[0]
    return (yf * torch.rsqrt(var + 1e-6) * p["gnorm"]["scale"].to(torch.float32)).to(y.dtype)


def out_proj(p: dict, y: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """out over the gated y: row-parallel where the mixer is split."""
    tp = lc.split_tp("mixer")
    if tp is None:
        return _dense_or_bin(p["out"], y, cfg)
    if "bin" in p["out"]:
        return binary_dense_apply_any(p["out"]["bin"], y, mode=cfg.policy.binary_mode,
                                      reduce=tp.all_reduce)
    return lc.row_parallel(p["out"], y, cfg, tp)


def ssd_chunked(xt, alpha_log, bm, cm, *, chunk: int, h0=None):
    """Chunked SSD.

    xt (B, L, H, P) the dt-scaled inputs; alpha_log (B, L, H) the log decay
    (negative); bm, cm (B, L, ds), shared across heads (n_groups = 1).
    -> (y (B, L, H, P), h_final (B, H, P, ds)). A ragged tail is padded
    with alpha_log 0 (a decay of 1) and zero inputs, which leave the state
    as the real tokens left it."""
    b, length, h, p = xt.shape
    ds = bm.shape[-1]
    l0 = length
    if length % chunk:
        pad = chunk - length % chunk
        xt = F.pad(xt, (0, 0, 0, 0, 0, pad))
        alpha_log = F.pad(alpha_log, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
        length += pad
    n = length // chunk
    xt = xt.reshape(b, n, chunk, h, p)
    al = alpha_log.reshape(b, n, chunk, h)
    bm = bm.reshape(b, n, chunk, ds)
    cm = cm.reshape(b, n, chunk, ds)

    cum = torch.cumsum(al, dim=2)                                  # (B, N, Q, H)
    # intra-chunk: S[b, n, h, i, j] = (C_i . B_j) exp(cum_i - cum_j), j <= i
    cb = torch.einsum("bnis,bnjs->bnij", cm, bm)                   # (B, N, Q, Q)
    cum_t = cum.transpose(2, 3)                                    # (B, N, H, Q)
    diff = cum_t[..., :, None] - cum_t[..., None, :]               # (B, N, H, Q, Q)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=xt.device).tril()
    # mask before exp: the upper triangle's positive differences overflow,
    # and exp(-inf) = 0 keeps the backward free of inf * 0
    dec = torch.where(tri, diff, float("-inf")).exp()
    s = cb[:, :, None] * dec
    y_intra = torch.einsum("bnhij,bnjhp->bnihp", s, xt)

    # inter-chunk state carry; the three-operand products of repro are
    # taken as a scaled operand times a two-operand product, so that no
    # (B, N, Q, H, P, ds) intermediate is formed
    g_end = torch.exp(cum[:, :, -1:, :] - cum)                     # (B, N, Q, H)
    contrib = torch.einsum("bnqhp,bnqs->bnhps", xt * g_end[..., None], bm)
    a_end = torch.exp(cum[:, :, -1, :])                            # (B, N, H)
    hcur = torch.zeros((b, h, p, ds), dtype=torch.float32, device=xt.device) \
        if h0 is None else h0
    hprevs = []
    for i in range(n):
        hprevs.append(hcur)
        hcur = a_end[:, i, :, None, None] * hcur + contrib[:, i]
    hprevs = torch.stack(hprevs, dim=1)                            # (B, N, H, P, ds)
    y_inter = torch.einsum("bnqs,bnhps->bnqhp", cm, hprevs) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, length, h, p)
    return y[:, :l0], hcur


def mamba_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *, return_state: bool = False):
    """Full-sequence forward, x (B, L, d); with ``return_state`` also the
    decode cache {"h": the final state, "conv": the conv input's last
    d_conv - 1 rows}."""
    di, nh, _ = local_dims(cfg)
    a_log, d_skip, dt_bias = _heads(p, cfg)
    xn = nn.rmsnorm_apply(p["norm"], x)
    z, conv_in, dt = _split_proj(p, xn, cfg)
    xs, bm, cm = _post_conv(_causal_conv(conv_in, p["conv_w"], p["conv_b"]), cfg)
    b, length, _ = x.shape
    dt = F.softplus(dt + dt_bias)                                  # (B, L, H)
    alpha_log = dt * -torch.exp(a_log)
    xh = xs.reshape(b, length, nh, HEAD_P)
    y, hfin = ssd_chunked(xh * dt[..., None], alpha_log, bm, cm,
                          chunk=min(cfg.ssm_chunk, length))
    y = (y + xh * d_skip[:, None]).reshape(b, length, di)
    y = _gnorm(p, (y * F.silu(z.to(torch.float32))).to(x.dtype), cfg)
    out = x + out_proj(p, y, cfg).to(x.dtype)
    if return_state:
        return out, {"h": hfin, "conv": conv_in[:, -(cfg.d_conv - 1):, :]}
    return out


def mamba_init_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    """Zero states of the rank's heads (all of them on one device)."""
    di, nh, _ = local_dims(cfg)
    return {"h": torch.zeros((batch, nh, HEAD_P, cfg.d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.d_conv - 1, di + 2 * cfg.d_state),
                                dtype=torch.float32, device=device)}


def mamba_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, cache: dict):
    """One-token recurrent step, x (B, 1, d) -> (out, the new cache)."""
    di, nh, _ = local_dims(cfg)
    a_log, d_skip, dt_bias = _heads(p, cfg)
    xn = nn.rmsnorm_apply(p["norm"], x)
    z, conv_in, dt = _split_proj(p, xn, cfg)                       # (B, 1, *)
    window = torch.cat([cache["conv"], conv_in], dim=1)            # (B, W, C)
    conv_out = torch.einsum("bwc,wc->bc", window.to(torch.float32), p["conv_w"]) + p["conv_b"]
    xs, bm, cm = _post_conv(conv_out[:, None, :], cfg)
    dt = F.softplus(dt[:, 0] + dt_bias)                            # (B, H)
    alpha = torch.exp(dt * -torch.exp(a_log))
    xh = xs[:, 0].reshape(-1, nh, HEAD_P)
    h = cache["h"] * alpha[..., None, None] + \
        torch.einsum("bhp,bs->bhps", xh * dt[..., None], bm[:, 0])
    y = torch.einsum("bs,bhps->bhp", cm[:, 0], h) + xh * d_skip[:, None]
    y = _gnorm(p, (y.reshape(-1, 1, di) * F.silu(z.to(torch.float32))).to(x.dtype), cfg)
    out = x + out_proj(p, y, cfg).to(x.dtype)
    return out, {"h": h, "conv": window[:, 1:, :]}
