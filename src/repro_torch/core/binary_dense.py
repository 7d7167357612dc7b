"""BinaryDense: the paper's binary layer (port of repro/core/binary_dense.py).

Training keeps a float latent weight ``w_latent`` (K, N), clipped to
[-1, 1] by optim/bnn.py; the latent path packs the current latent on every
forward (kernels/ops.binary_dense), so it never reads a stale copy. At
deploy time ``pack_for_inference`` drops the latent for the packed sign
words ``w_packed`` (N, K/32) — Table II's 16x memory cut.

A per-output ``scale`` (init 1/sqrt(K)) maps the integer dot back to unit
variance; the paper's MLP relies on its BatchNorm instead (scale=False).

The LM serving path keeps both: ``with_packed`` adds ``w_packed`` once, when
the model is created or loaded, and serving reads only that copy. An
optimizer step changes the latent and leaves that copy stale, so the
trainer holds latent-only params, and ``pack_tree`` adds the copies where
trained params go to serving. ``binary_dense_apply_any`` dispatches on
what a dict holds: the packed words, else the latent (training), else the
+-1 int8 weights that models/deploy.py writes for int8 mode.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.binarize import pack_bits, pack_signs_int8, packed_len
from repro_torch.kernels import ops
from repro_torch.tree import map_binary_denses


def binary_dense_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
                      device, scale: bool = True, dtype=torch.float32) -> dict:
    """w_latent ~ U(-1, 1), as repro draws it (from torch's generator, so
    not the same numbers)."""
    w = torch.rand((in_dim, out_dim), generator=generator, device=device) * 2 - 1
    p = {"w_latent": w.to(dtype)}
    if scale:
        p["scale"] = torch.full((out_dim,), 1.0 / math.sqrt(in_dim),
                                dtype=torch.float32, device=device)
    return p


def binary_dense_apply(p: dict, x: torch.Tensor, *, mode: str = "xnor",
                       reduce=None) -> torch.Tensor:
    """Latent-weight path (training and eval with latents). ``reduce``, as
    in binary_dense_apply_packed, sums a row-parallel shard's exact dot
    before the cast; the STE backward stays local to the shard."""
    y = ops.binary_dense(x, p["w_latent"], mode=mode, reduce=reduce)
    if "scale" in p:
        y = y * p["scale"]
    return y.to(x.dtype)


def pack_for_inference(p: dict) -> dict:
    """Latent params -> deploy params (packed sign words, no latent). The
    contraction length K is not a leaf: pass it to binary_dense_apply_packed
    or let it default to x.shape[-1]."""
    q = {"w_packed": pack_bits(p["w_latent"].T)}
    if "scale" in p:
        q["scale"] = p["scale"]
    return q


def with_packed(p: dict) -> dict:
    """The latent params with the packed copy added (the LM's weights,
    packed once at load)."""
    return {**p, **pack_for_inference(p)}


def pack_tree(tree):
    """``with_packed`` on every binary dense (a dict with a ``w_latent``) of
    a param tree of dicts and lists; the other leaves are shared."""
    return map_binary_denses(with_packed, tree)


def binary_dense_apply_packed(q: dict, x: torch.Tensor, *, k: int | None = None,
                              mode: str = "xnor", reduce=None) -> torch.Tensor:
    """Packed-weight path. The integer dot comes in x's dtype, before the
    scale, the order of repro's latent path (repro/core/binary_dense.py:36-39)
    that the LM reference runs; in f32 (the MLP) that equals repro's packed
    path exactly. ``reduce`` (a rank's partial dot over its rows of a
    row-parallel weight -> the sum over ranks) runs on the exact dot,
    before the cast."""
    y = ops.binary_dense_packed(x, q["w_packed"], k, mode=mode, reduce=reduce)
    if "scale" in q:
        y = y * q["scale"]
    return y.to(x.dtype)


def binary_dense_apply_any(p: dict, x: torch.Tensor, *, mode: str = "xnor",
                           reduce=None) -> torch.Tensor:
    """Dispatch on representation (repro/core/binary_dense.py:61-79): the
    packed sign words (deployed xnor, or the serving copy; through
    ``mode``'s kernel), else the latent (training, STE backward), else
    ``w_int8`` (N, K) +-1 int8 (deployed int8).

    repro reads the latent first. Here the packed copy comes first, so
    that a serving tree, which holds both, skips re-packing the latent at
    every call: the two give the same integer dot. A training tree holds
    no packed copy (train/step.py refuses one), so the loss reads the
    latent through the STE.

    The reference lowers ``w_int8`` to an XLA int8 dot, not a Pallas
    kernel, so here it is the plain product in f32, which is exact: every
    partial sum of +-1 terms is an integer below 2**24. The dot then
    scales in f32, as the reference's does.

    ``reduce`` sums a row-parallel shard's exact dot over the ranks, before
    the cast and the scale, on every path."""
    if "w_packed" in p:
        return binary_dense_apply_packed(p, x, mode=mode, reduce=reduce)
    if "w_latent" in p:
        return binary_dense_apply(p, x, mode=mode, reduce=reduce)
    if "w_int8" in p:
        lead = x.shape[:-1]
        a = pack_signs_int8(x.reshape(-1, x.shape[-1])).to(torch.float32)
        y = a @ p["w_int8"].to(torch.float32).T
        if reduce is not None:
            y = reduce(y)
        if "scale" in p:
            y = y * p["scale"]
        return y.reshape(*lead, -1).to(x.dtype)
    raise KeyError(f"no binary weight in {list(p)}")


def binary_dense_bytes(in_dim: int, out_dim: int) -> int:
    """Deployed weight bytes (packed)."""
    return packed_len(in_dim) * 4 * out_dim
