"""Carry repro's params over to the port, so both run on the same weights.

``params_from_jax(tree, cfg)`` takes repro's param pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)`` on the caller's
side: this package imports no jax) and returns the port's params:

  * each stacked ``blocks/seg{i}`` leaf (leading layer axis) is split into
    the port's per-layer dicts, following ``build_segments``;
  * bf16 arrays (numpy's ml_dtypes bfloat16) are reinterpreted bit for bit;
  * each binary dense gets its packed sign words (``w_packed``) from its
    latent weight, as the port's own init does; with ``packed=False`` it
    keeps its latent only, as the trainer holds it (so repro's params,
    grads and AdamW moments all come across as one tree shape);
  * an MoE layer's expert stacks (E, K, N) and its f32 router split per
    layer like every other leaf and are not packed (``pack_tree`` packs
    the ``w_latent`` denses only); deployed ``*_q`` stacks come across as
    int8, or as int32 words with the bits of repro's uint32.

``caches_from_jax(tree, cfg)`` takes a repro KV cache pytree (contiguous or
paged, any codec; numpy leaves) and returns the port's list of per-layer
cache dicts: each ``seg{i}`` leaf is split along its layer axis, and packed
uint32 words become int32 words with the same bits.

``mlp_params_from_jax(tree)`` takes repro's hybrid-MLP params
(core/hybrid_mlp.py), latent or packed, with numpy leaves, and keeps their
structure; repro's uint32 ``w_packed`` words become the port's int32 words
with the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.binary_dense import pack_tree
from repro_torch.device import resolve_device
from repro_torch.models import lm_common as lc
from repro_torch.tree import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda",
                    packed: bool = True) -> dict:
    device = resolve_device(device)
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in tree.items() if k != "blocks"}
    blocks = []
    for si, (sig, start, count) in enumerate(lc.build_segments(cfg)):
        seg = tree["blocks"][f"seg{si}"]
        for i in range(count):
            blocks.append(tree_map(lambda a, i=i: _tensor(a[i], device), seg))
    out["blocks"] = pack_tree(blocks) if packed else blocks
    return out


def caches_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda") -> list:
    device = resolve_device(device)
    caches = []
    for si, (_, _, count) in enumerate(lc.build_segments(cfg)):
        seg = tree[f"seg{si}"]
        caches += [{k: _tensor(np.asarray(a)[i], device) for k, a in seg.items()}
                   for i in range(count)]
    return caches


def mlp_params_from_jax(tree: dict, *, device="cuda") -> dict:
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), tree)
