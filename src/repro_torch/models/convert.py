"""Carry repro's params over to the port, so both run on the same weights.

``params_from_jax(tree, cfg)`` takes repro's param pytree with every leaf
already a numpy array (``jax.tree.map(np.asarray, params)`` on the caller's
side: this package imports no jax) and returns the port's params:

  * each stacked ``blocks/seg{i}`` leaf (leading layer axis) is split into
    the port's per-layer dicts, following ``build_segments`` (rwkv6: its
    ``_segments``); so are zamba2's ``blocks/run{i}`` (following its
    ``_runs``), whisper's ``dec_blocks/seg{i}`` (following its
    ``_dec_segments``) and its ``enc_blocks``, and a VLM's ``cross`` (one
    stack each, over every layer); every other key (an MTP head's ``mtp``
    and zamba2's ``shared`` block among them) is one unstacked tree and
    comes across whole;
  * bf16 arrays (numpy's ml_dtypes bfloat16) are reinterpreted bit for bit;
  * each binary dense gets its packed sign words (``w_packed``) from its
    latent weight, as the port's own init does; with ``packed=False`` it
    keeps its latent only, as the trainer holds it (so repro's params,
    grads and AdamW moments all come across as one tree shape);
  * an MoE layer's expert stacks (E, K, N) and its f32 router split per
    layer like every other leaf and are not packed (``pack_tree`` packs
    the ``w_latent`` denses only); deployed ``*_q`` stacks come across as
    int8, or as int32 words with the bits of repro's uint32.

``caches_from_jax(tree, cfg)`` takes a repro decode cache pytree (numpy
leaves) and returns the port's: for an LM's KV cache (contiguous or paged,
any codec) and rwkv6's states, the list of per-layer dicts, each
``seg{i}`` leaf split along its layer axis; for zamba2, {"mamba": one
{"h", "conv"} a block, from its ``run`` stacks, "attn": one codec cache an
invocation of the shared block, from their stack}. Packed uint32 words
become int32 words with the same bits.

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
from repro_torch.tree import tree_leaves, tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                  # a writable copy the tensor may own
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    elif a.dtype == np.uint32:
        t = torch.from_numpy(a.view(np.int32))
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _unstack(stack, count: int, device) -> list:
    """A stacked tree (every leaf with a leading axis of ``count`` layers)
    -> ``count`` per-layer trees."""
    for leaf in tree_leaves(stack):
        if np.shape(leaf)[0] != count:
            raise ValueError(f"a stacked leaf of shape {np.shape(leaf)} does not hold "
                             f"{count} layers")
    return [tree_map(lambda a, i=i: _tensor(a[i], device), stack) for i in range(count)]


def _block_stacks(cfg: ModelConfig) -> tuple[str, list[int]]:
    """-> (the key prefix of repro's stacks of ``blocks``, each stack's
    count of layers)."""
    if cfg.family == "mamba2_hybrid":
        from repro_torch.models.zamba2 import _runs
        return "run", [count for _, count, _ in _runs(cfg)]
    if cfg.family == "rwkv6":
        from repro_torch.models.rwkv6_lm import _segments
        return "seg", [count for _, count, _ in _segments(cfg)]
    return "seg", [count for _, _, count in lc.build_segments(cfg)]


def params_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda",
                    packed: bool = True) -> dict:
    device = resolve_device(device)
    out = {}
    for k, v in tree.items():
        prefix = "seg"
        if k == "blocks":
            prefix, counts = _block_stacks(cfg)
        elif k == "dec_blocks":
            from repro_torch.models.whisper import _dec_segments
            counts = [count for _, count, _ in _dec_segments(cfg)]
        elif k in ("enc_blocks", "cross"):
            out[k] = _unstack(v, cfg.enc_layers if k == "enc_blocks"
                              else cfg.n_layers // cfg.cross_every, device)
            continue
        else:
            out[k] = tree_map(lambda a: _tensor(a, device), v)
            continue
        if len(v) != len(counts):
            raise ValueError(f"{k}: {len(v)} stacked segments, the config has {len(counts)}")
        out[k] = [blk for si, count in enumerate(counts)
                  for blk in _unstack(v[f"{prefix}{si}"], count, device)]
    return pack_tree(out) if packed else out


def caches_from_jax(tree: dict, cfg: ModelConfig, *, device="cuda"):
    device = resolve_device(device)
    if cfg.family == "mamba2_hybrid":
        from repro_torch.models.zamba2 import _runs, n_shared_calls
        return {"mamba": [blk for stack, (_, count, _) in zip(tree["mamba"], _runs(cfg))
                          for blk in _unstack(stack, count, device)],
                "attn": _unstack(tree["attn"], n_shared_calls(cfg), device)}
    _, counts = _block_stacks(cfg)
    return [blk for si, count in enumerate(counts)
            for blk in _unstack(tree[f"seg{si}"], count, device)]


def mlp_params_from_jax(tree: dict, *, device="cuda") -> dict:
    device = resolve_device(device)
    return tree_map(lambda a: _tensor(a, device), tree)
