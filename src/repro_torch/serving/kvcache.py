"""KV cache of the serving pool: the bf16 codec (port of the bf16 parts of
repro/serving/kvcache.py).

A model's caches are a list with one dict per layer (repro stacks the
layers of a segment on a leading axis; the port loops over layers):

    {"k": (B, T, Hkv, D), "v": (B, T, Hkv, D), "len": (B,) int32}

in the compute dtype. Every read masks positions >= len, so rows past a
sequence's length are invisible. The quantized codecs (int8, binary) and
the paged pool come in later slices (ROADMAP A3, A4).

The port updates the pool in place where repro returns a new pool (repro
donates the old one to XLA for the same effect).
"""

from __future__ import annotations

import torch

from repro_torch.nn import attention as attn_lib


def init(batch: int, max_len: int, n_kv: int, head_dim: int,
         dtype=torch.bfloat16, *, device) -> dict:
    return attn_lib.init_kv_cache(batch, max_len, n_kv, head_dim, dtype,
                                  device=device)


def _pad_time(a: torch.Tensor, max_len: int) -> torch.Tensor:
    """Pad (B, S, ...) with zeros to (B, max_len, ...) along axis 1."""
    out = a.new_zeros((a.shape[0], max_len, *a.shape[2:]))
    out[:, :a.shape[1]] = a
    return out


def from_prefill(k: torch.Tensor, v: torch.Tensor, max_len: int) -> dict:
    """A prefilled (B, S, H, D) k/v pair as a max_len cache, len = S."""
    b, s = k.shape[:2]
    return {"k": _pad_time(k, max_len), "v": _pad_time(v, max_len),
            "len": torch.full((b,), s, dtype=torch.int32, device=k.device)}


def insert_timestep(cache: dict, k_new, v_new) -> dict:
    """Insert one token per sequence at position cache['len'] (in place)."""
    return attn_lib.cache_update_decode(cache, k_new, v_new)


def decode_attention(q, cache: dict, *, scale=None, impl: str = "auto"):
    return attn_lib.decode_attention(q, cache["k"], cache["v"],
                                     kv_len=cache["len"], scale=scale, impl=impl)


def set_cache_lengths(caches: list, seq_lens: torch.Tensor) -> list:
    """Reset every layer's lengths after a right-padded prefill: the pad
    positions become invisible, and the next decode overwrites position
    seq_lens — a padded prefill then decodes exactly as an unpadded one."""
    seq_lens = seq_lens.to(torch.int32)
    for c in caches:
        c["len"] = seq_lens.clone()
    return caches


def cache_insert_slots(pool: list, new: list, slots: torch.Tensor) -> list:
    """Scatter per-request prefill caches into pool slots, in place.

    pool layers are (max_batch, ...) and new layers (G, ...) with the same
    trailing dims (prefill runs at the pool's max_len). slots (G,) gives the
    destination row per request; entries >= max_batch are dropped, as
    repro's ``mode="drop"`` scatter drops them, which lets a prefill group
    be padded without a spare slot to aim at."""
    max_batch = pool[0]["len"].shape[0]
    slots = torch.as_tensor(slots, device=pool[0]["len"].device).to(torch.int64)
    keep = torch.nonzero(slots < max_batch).squeeze(1)
    dst = slots[keep]
    for dst_layer, src_layer in zip(pool, new):
        for name, buf in dst_layer.items():
            buf[dst] = src_layer[name][keep].to(buf.dtype)
    return pool


def kv_pool_bytes(caches: list) -> int:
    """Resident bytes of the pool, without the small ``len`` leaves."""
    return sum(t.numel() * t.element_size()
               for c in caches for name, t in c.items() if name != "len")
