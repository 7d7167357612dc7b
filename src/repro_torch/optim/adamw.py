"""AdamW, the cosine schedule and global-norm clipping (port of
repro/optim/adamw.py), as plain torch ops on the port's param trees.

Not ``torch.optim.AdamW``: that rounds in another order and keeps bf16
params' state its own way. Here every leaf is updated in f32 by the
reference's formula and cast back to its dtype, and the moments are kept
in ``moment_dtype`` (bf16 halves optimizer memory). Every function returns
new tensors and changes none it is given, so a step that fails halfway
can be run again from the same inputs (train/fault_tolerance.py).

The step count is a 0-d int32 tensor on the params' device, and the
learning rate a 0-d f32 tensor computed from it there: a step reads
nothing back to the host.
"""

from __future__ import annotations

import math

import torch

from repro_torch.tree import tree_leaves, tree_map


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor`` x
    ``peak_lr`` at ``total``; ``step`` an int or a 0-d tensor."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * (step + 1) / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def clip_by_global_norm(grads, max_norm: float, *, split=None, reduce=None):
    """-> (grads scaled so that their global L2 norm is at most max_norm,
    each in its own dtype; the norm before clipping, f32).

    On a tensor-parallel rank (``split``: a tree of bools, True where the
    leaf is this rank's shard of a split parameter; ``reduce``: the sum of
    a 0-d tensor over the ranks) the norm counts every parameter once: the
    shards' squares summed over the ranks, the replicated leaves' once."""
    sq = lambda g: torch.sum(torch.square(g.to(torch.float32)))  # noqa: E731
    if split is None:
        gn = torch.sqrt(sum(sq(g) for g in tree_leaves(grads)))
    else:
        own = torch.zeros((), dtype=torch.float32, device=tree_leaves(grads)[0].device)
        rep = torch.zeros_like(own)
        for g, s in zip(tree_leaves(grads), tree_leaves(split)):
            if s:
                own = own + sq(g)
            else:
                rep = rep + sq(g)
        gn = torch.sqrt(reduce(own) + rep)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gn


def adamw_init(params, *, moment_dtype=torch.float32) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)  # noqa: E731
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params, grads, state: dict, *, lr, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1):
    """One AdamW step -> (new params, new state)."""
    step = state["step"] + 1
    t = step.to(torch.float32)
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t

    def upd(p, g, m, v):
        gf = g.to(torch.float32)
        m2 = b1 * m.to(torch.float32) + (1 - b1) * gf
        v2 = b2 * v.to(torch.float32) + (1 - b2) * gf * gf
        delta = (m2 / c1) / (torch.sqrt(v2 / c2) + eps) + weight_decay * p.to(torch.float32)
        p2 = p.to(torch.float32) - lr * delta
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    with torch.no_grad():
        out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda o: o[i], out)  # noqa: E731
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}
