"""Train step factory (port of repro/train/step.py): loss and gradients,
global-norm clipping, AdamW under the cosine schedule and the BNN latent
clip, with optional gradient accumulation over microbatches.

The step is functional: it returns new params and a new optimizer state
and changes none of the tensors it is given, so a step that fails halfway
can be retried from the same inputs (train/fault_tolerance.py). It takes
latent-only params (``api.init(..., packed=False)``): a binary dense's
packed serving copy would go stale at the first update, so a tree that
holds one is refused; ``core/binary_dense.pack_tree`` adds the copies
where trained params go to serving.

On a mesh (``plan``, launch/specs.TrainPlan) a rank takes its shard of
the params and moments and its rows of the batch. The forward runs in the
plan's tensor-parallel scope, whose collectives carry the gradients over
``model``; the gradients are then averaged over ``data`` in f32 buckets,
and so are the loss and the metrics; the global norm counts each
parameter once; AdamW and the latent clip run on the shard unchanged.
With equal rows a rank, the mean of the ranks' mean token losses is the
global batch's, as GSPMD computes it: the loss and the update are the
single device's up to rounding. (An MoE's router aux loss and capacity are
taken over a rank's rows, not the global batch's.)
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.distributed.sharding import tensor_parallel
from repro_torch.optim import (adamw_update, clip_by_global_norm, clip_latent_weights,
                               cosine_schedule)
from repro_torch.tree import tree_leaves_with_path, tree_map, tree_unflatten_like


def value_and_grad(loss_fn, params, batch: dict):
    """-> (loss, metrics, grads): the gradient of ``loss_fn(params, batch)
    -> (loss, metrics)`` for every leaf of ``params``, in the leaf's
    dtype, as jax.value_and_grad gives it (zeros for a leaf the loss does
    not reach differentiably, such as a sigmoid router's bias, which only
    picks the experts); loss and metrics detached."""
    leaves = tree_leaves_with_path(params)
    fixed = [path for path, t in leaves if not t.is_floating_point()]
    if fixed:
        raise ValueError(f"the trainer takes latent-only params; {fixed[:3]} hold no "
                         "gradient (a packed copy would go stale at the first step: "
                         "init with packed=False)")
    live = [t.detach().requires_grad_() for _, t in leaves]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten_like(params, live), batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for t, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten_like(params, grads))


def loss_and_grads(api, params, batch: dict):
    """value_and_grad of ``api.loss``."""
    return value_and_grad(api.loss, params, batch)


def accumulated_loss_and_grads(api, params, batch: dict, grad_accum: int = 1):
    """loss_and_grads, over ``grad_accum`` microbatches when it is > 1: the
    batch leaves are then (accum, mb, ...), the f32 gradients are summed
    and divided by their count, the loss and metrics averaged."""
    if grad_accum == 1:
        return loss_and_grads(api, params, batch)
    acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                   params)
    losses, metricses = [], []
    for i in range(grad_accum):
        loss, metrics, grads = loss_and_grads(api, params, {k: v[i] for k, v in batch.items()})
        acc = tree_map(torch.add, acc, grads)
        losses.append(loss)
        metricses.append(metrics)
    metrics = {k: torch.stack([m[k] for m in metricses]).mean() for k in metricses[0]}
    return torch.stack(losses).mean(), metrics, tree_map(lambda g: g / grad_accum, acc)


def make_train_step(api, cfg, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total: int = 10000, grad_accum: int = 1, max_grad_norm: float = 1.0,
                    weight_decay: float = 0.1, plan=None):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), the gradients taken over ``grad_accum`` microbatches. ``cfg``
    is the reference's argument; the latent clip finds the binary layers by
    their keys (optim/bnn.py). With ``plan`` (a TrainPlan) the step is one
    rank's (module note): it takes this rank's shards and its batch rows
    (``plan.dp.rows``), and every rank of the mesh must call it."""

    def train_step(params, opt_state, batch):
        scope = contextlib.nullcontext() if plan is None else tensor_parallel(plan.tp)
        with scope:
            _, metrics, grads = accumulated_loss_and_grads(api, params, batch, grad_accum)
        with torch.no_grad():
            clip = {}
            if plan is not None:
                grads, metrics = plan.sync(grads, metrics)
                clip = plan.clip_args(api, grads)
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm, **clip)
            lr = cosine_schedule(opt_state["step"], peak_lr=peak_lr, warmup=warmup,
                                 total=total)
            params, opt_state = adamw_update(params, grads, opt_state, lr=lr,
                                             weight_decay=weight_decay)
            params = clip_latent_weights(params)
        return params, opt_state, {**metrics, "grad_norm": gnorm, "lr": lr}

    return train_step


def make_eval_step(api):
    def eval_step(params, batch):
        with torch.no_grad():
            return api.loss(params, batch)[1]
    return eval_step
