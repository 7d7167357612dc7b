"""Layers as plain functions over dicts of tensors (port of repro/nn/layers.py).

Conventions, as in repro: dense weights are stored (in_dim, out_dim) and
applied as x @ w; param and compute dtypes are passed by the caller. Init
functions draw from an explicit ``torch.Generator`` on an explicit device,
with repro's distributions (not its numbers).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _normal(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


# ---------------------------------------------------------------------------
# dense / embedding
# ---------------------------------------------------------------------------

def dense_init(in_dim: int, out_dim: int, *, generator, device, bias: bool = False,
               dtype=torch.bfloat16, scale: float | None = None) -> dict:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    p = {"w": (_normal((in_dim, out_dim), generator, device) * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def dense_apply(p: dict, x: torch.Tensor, *, compute_dtype=torch.bfloat16,
                binary_impl: str = "auto"):
    if "w_packed" in p:
        # the binarized self-draft's weights (serving/spec.py), XNOR-net
        # style:  x @ W ~= (sign(x) @ sign(W)) * beta * alpha  with alpha the
        # per-output mean |W| baked into ``scale`` and beta the per-token
        # mean |x|, in f32 (repro/nn/layers.py:35-55). ``binary_impl`` is
        # ModelConfig.spec_draft_impl: the packed product's lowering
        # (kernels/ops.draft_mode), exact integers either way
        from repro_torch.core.binary_dense import binary_dense_apply_packed
        from repro_torch.kernels.ops import draft_mode
        xf = x.to(torch.float32)
        beta = xf.abs().mean(dim=-1, keepdim=True)
        y = binary_dense_apply_packed(p, xf, mode=draft_mode(binary_impl)) * beta
        if "b" in p:
            y = y + p["b"].to(torch.float32)
        return y.to(compute_dtype)
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def embedding_init(vocab: int, dim: int, *, generator, device,
                   dtype=torch.bfloat16) -> dict:
    return {"table": (_normal((vocab, dim), generator, device) * 0.02).to(dtype)}


def embedding_lookup(p: dict, ids: torch.Tensor, *, compute_dtype=torch.bfloat16):
    return p["table"][ids].to(compute_dtype)


def embedding_logits(p: dict, x: torch.Tensor, *, compute_dtype=torch.bfloat16):
    """Tied-head readout: x @ table.T."""
    return x.to(compute_dtype) @ p["table"].to(compute_dtype).T


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_init(dim: int, *, device, dtype=torch.float32) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm_apply(p: dict, x: torch.Tensor, *, eps: float = 1e-6):
    """In f32 inside, back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def batchnorm_init(dim: int, *, device, dtype=torch.float32) -> dict:
    """BatchNorm1d as in the paper's MLP (running stats for inference)."""
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device),
            "mean": torch.zeros((dim,), dtype=dtype, device=device),
            "var": torch.ones((dim,), dtype=dtype, device=device)}


def batchnorm_apply(p: dict, x: torch.Tensor, *, training: bool,
                    momentum: float = 0.9, eps: float = 1e-5):
    """x (batch, dim) -> (y, new params), in f32 inside, with repro's
    conventions, which are not nn.BatchNorm1d's: the batch variance is the
    population one (no Bessel correction, in the output and the running
    stat alike), and ``new = momentum * old + (1 - momentum) * batch``.
    Gradients flow through the batch statistics; the running stats carry
    none."""
    xf = x.to(torch.float32)
    if training:
        mu = xf.mean(dim=0)
        var = ((xf - mu) ** 2).mean(dim=0)
        new = {**p,
               "mean": momentum * p["mean"] + (1 - momentum) * mu.detach(),
               "var": momentum * p["var"] + (1 - momentum) * var.detach()}
    else:
        mu, var, new = p["mean"], p["var"], p
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype), new


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU) for float transformer blocks
# ---------------------------------------------------------------------------

def swiglu_init(dim: int, hidden: int, *, generator, device,
                dtype=torch.bfloat16) -> dict:
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {"w_gate": dense_init(dim, hidden, **kw),
            "w_up": dense_init(dim, hidden, **kw),
            "w_down": dense_init(hidden, dim, **kw)}


def swiglu_apply(p: dict, x: torch.Tensor, *, compute_dtype=torch.bfloat16,
                 binary_impl: str = "auto"):
    """silu in f32, as repro/models/lm_common.py:88. ``binary_impl`` picks
    the packed lowering where the denses are the self-draft's packed ones."""
    kw = dict(compute_dtype=compute_dtype, binary_impl=binary_impl)
    g = dense_apply(p["w_gate"], x, **kw)
    u = dense_apply(p["w_up"], x, **kw)
    h = F.silu(g.to(torch.float32)).to(compute_dtype) * u
    return dense_apply(p["w_down"], h, **kw)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(dim: int, *, base: float = 10000.0, device=None):
    return 1.0 / (base ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, base: float = 10000.0):
    """x (..., S, H, D) with D even; positions (..., S). The head splits into
    halves (x1, x2), not interleaved pairs."""
    d = x.shape[-1]
    inv = rope_freqs(d, base=base, device=x.device)
    ang = positions[..., :, None].to(torch.float32) * inv      # (..., S, D/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
