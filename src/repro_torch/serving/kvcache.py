"""KV-cache codecs and the paged pool (port of repro/serving/kvcache.py).

A model's caches are a list with one dict per layer (repro stacks the
layers of a segment on a leading axis; the port loops over layers). Every
leaf but the index leaves carries time on axis 1, in one of three codecs:

  bf16     {"k", "v": (B, T, Hkv, D) compute dtype}; ``"auto"`` resolves
           here
  int8     {"k_q", "v_q": (B, T, Hkv, D) int8, "k_s", "v_s": (B, T, Hkv)
           bf16}: per-(token, head) absmax, D + 2 bytes per head-row
  binary   {"k_p", "v_p": (B, T, Hkv, ceil(D / 32)) int32 sign words,
           "k_s", "v_s": bf16 absmean scales}: 4 ceil(D / 32) + 2 bytes

plus ``"len": (B,) int32``; every read masks positions >= len. Quantized
decode attends through ``kernels/kv_decode.py``: for a CUDA tensor one
kernel per layer and step dequantizes the codes in registers (B4b's and
B4d's math) inside the online softmax, reading only the positions below
len (repro scans kv blocks with the XLA twins fused into the block load);
for a CPU tensor the reference's recurrence runs. Inserting goes through
the insert kernel of ``kernels/kv_quant.py`` (B4a, B4c: one launch encodes
K and V and writes them into the pool, contiguous, paged or at prefill),
and the context of a cached prefix through B4b, B4d: a CUDA tensor never
meets a plain version.

The paged pool replaces each slot's private (max_len, ...) region with one
shared pool of (n_blocks, block_size, ...) blocks per layer in any codec's
layout, plus ``"table": (max_batch, n_pages) int32`` (the physical block of
each slot's page; entries >= n_blocks are holes) and ``"len"``. A cache dict
with a ``"table"`` leaf is paged. Its leaves hold one spare block past the
n_blocks that tables address: writes through a hole land there, where
repro's ``mode="drop"`` drops them, so a decode insert needs no host sync to
find the rows it keeps. No decode attends to the spare block (a hole clamps
to it only past a slot's length), and the pool's bytes leave it out.

The port updates the pool in place where repro returns a new pool (repro
donates the old one to XLA for the same effect): every write, the lengths
included, goes into the tensors the pool already holds, and no leaf is
ever rebound, so a CUDA graph that captured a decode step or a speculative
wave (serving/graphs.py) reads and writes the pool the engine holds on
every replay. The speculative verify inserts a span of S = k + 1 tokens a
slot (``insert_span``, ``paged_insert_span``: one launch of the insert
kernel a layer on the quantized codecs) and attends with per-query lengths
(``q_lens``: query j of slot b below q_lens[b, j]).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.binarize import packed_len
from repro_torch.kernels import kv_decode as kvd
from repro_torch.kernels import kv_quant as kvq
from repro_torch.nn import attention as attn_lib
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_unflatten_like

_INDEX_LEAVES = ("len", "table")


# ---------------------------------------------------------------------------
# layout-generic ops (every codec shares these; lm_common delegates here)
# ---------------------------------------------------------------------------

def set_cache_lengths(caches: list, seq_lens: torch.Tensor) -> list:
    """Reset every layer's lengths after a right-padded prefill: the pad
    positions become invisible, and the next decode overwrites position
    seq_lens — a padded prefill then decodes exactly as an unpadded one. The
    speculative wave's rewind and the engine's rollback after it use it too.
    In place: each layer's ``len`` tensor is written, never rebound."""
    for c in caches:
        c["len"].copy_(seq_lens)
    return caches


def _kept(idx: torch.Tensor, limit: int) -> torch.Tensor:
    """Positions of the entries of ``idx`` below ``limit``: the rows a
    scatter keeps where repro's ``mode="drop"`` drops the rest."""
    return torch.nonzero(idx < limit).squeeze(-1)


def cache_insert_slots(pool: list, new: list, slots: torch.Tensor) -> list:
    """Scatter per-request prefill caches into pool slots, in place.

    pool layers are (max_batch, ...) and new layers (G, ...) with the same
    trailing dims (prefill runs at the pool's max_len). slots (G,) gives the
    destination row per request; entries >= max_batch are dropped, which
    lets a prefill group be padded without a spare slot to aim at. Every
    codec's leaves line up, since prefill encodes into the pool's codec."""
    max_batch = pool[0]["len"].shape[0]
    slots = torch.as_tensor(slots, device=pool[0]["len"].device).to(torch.int64)
    keep = _kept(slots, max_batch)
    dst = slots[keep]
    for dst_layer, src_layer in zip(pool, new):
        for name, buf in dst_layer.items():
            buf[dst] = src_layer[name][keep].to(buf.dtype)
    return pool


def _leaf_bytes(name: str, t: torch.Tensor, paged: bool) -> int:
    """A leaf's bytes, without a paged layer's spare hole block."""
    if name not in _INDEX_LEAVES and paged:
        t = t[:-1]
    return t.numel() * t.element_size()


def _pool_leaves(caches) -> list:
    """[(path, leaf name, leaf, paged)] of a cache tree of any family (a
    list of layer dicts, zamba2's {"mamba", "attn"}, the VLM's {"self",
    "cross"}) in tree_leaves_with_path's order; ``paged``: the leaf's layer
    holds a ``table``."""
    leaves = tree_leaves_with_path(caches)
    paged = {p.rpartition("/")[0] for p, _ in leaves if p.rpartition("/")[2] == "table"}
    return [(p, p.rpartition("/")[2], t, p.rpartition("/")[0] in paged) for p, t in leaves]


def kv_pool_bytes(caches) -> int:
    """Resident bytes of the pool without the small ``len`` / ``table``
    leaves (and a paged pool's spare block), so the number compares directly
    with bytes_per_token * tokens; a recurrent state's leaves count whole."""
    return sum(_leaf_bytes(name, t, paged) for _, name, t, paged in _pool_leaves(caches)
               if name not in _INDEX_LEAVES)


def kv_pool_byte_breakdown(caches: list) -> dict:
    """Resident pool bytes by leaf role: ``values`` (k/v, k_q/v_q, k_p/v_p),
    ``scales`` (the ``*_s`` leaves) and ``index`` (``len``, ``table``)."""
    out = {"values": 0, "scales": 0, "index": 0}
    for c in caches:
        for name, t in c.items():
            role = ("index" if name in _INDEX_LEAVES
                    else "scales" if name.endswith("_s") else "values")
            out[role] += _leaf_bytes(name, t, "table" in c)
    return out


# ---------------------------------------------------------------------------
# cache sharding (repro/serving/kvcache.py:128-198)
#
# Every codec's layout obeys one naming convention, which makes the rule
# name-driven instead of shape-driven:
#
#   values leaves  k, v, ek, ev, k_q, v_q, k_p, v_p   head axis at dim -2,
#                                                     time axis at dim -3
#   scale leaves   k_s, v_s                           head axis at dim -1,
#                                                     time axis at dim -2
#   index leaves   len, table                         replicated (host-
#                                                     driven scatters)
#
# and any leading dims (the slot batch or a paged pool's block axis) are
# unsharded. MLA's compressed ``c`` / ``kr`` leaves have no head axis and
# stay replicated. The recurrent states follow repro's CACHE_RULES: Mamba2's
# ``h`` and RWKV6's ``tm_s`` (B, H, P, N) split their heads, Mamba2's
# ``conv`` (B, W - 1, C) its channels (MeshRules.cuts keep B and C whole),
# and RWKV6's ``tm_x`` / ``cm_x`` and the VLM's ``cross`` stay whole. The
# same spec covers the contiguous pool (B, T, H, D), the paged pool
# (n_blocks + 1, block, H, D) and prefill outputs: a rank holds its heads
# of every one of them.
# ---------------------------------------------------------------------------

_KV_VALUE_LEAVES = frozenset(["k", "v", "ek", "ev", "k_q", "v_q", "k_p", "v_p"])
_KV_SCALE_LEAVES = frozenset(["k_s", "v_s"])


def cache_partition_specs(caches, mesh, mesh_rules):
    """A spec tree (distributed/sharding.py) for a cache pool of either
    layout and any codec. ``mesh`` needs only axis names (a stand-in will
    do); ``mesh_rules`` comes from launch/specs.mesh_rules_for, so that the
    head-count fallbacks apply."""
    from repro_torch.distributed.sharding import axis_names
    names = axis_names(mesh)
    head = mesh_rules.mesh_axes("cache_heads", names)
    seq = mesh_rules.mesh_axes("cache_seq", names)

    def spec_for(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name in _KV_VALUE_LEAVES:
            return (None,) * (leaf.ndim - 3) + (seq, head, None)
        if name in _KV_SCALE_LEAVES:
            return (None,) * (leaf.ndim - 2) + (seq, head)
        if name in ("h", "tm_s"):
            return (None, mesh_rules.mesh_axes("heads", names), None, None)
        if name == "conv":
            return (None, None, mesh_rules.mesh_axes("dconv", names))
        return ()
    return tree_unflatten_like(caches, [spec_for(p, t) for p, t in
                                        tree_leaves_with_path(caches)])


def kv_pool_bytes_per_device(caches, mesh=None, mesh_rules=None) -> int:
    """The bytes of kv_pool_bytes that each device holds of the whole pool
    ``caches`` (shapes suffice) under cache_partition_specs and the rules'
    cuts: kv_pool_bytes itself without a mesh, about kv_bytes / N with the
    head axis split N ways, and kv_bytes for an all-MLA pool, whose
    compressed leaves every rank holds whole."""
    if mesh is None:
        return kv_pool_bytes(caches)
    from repro_torch.distributed.sharding import shard_shape
    specs = tree_leaves(cache_partition_specs(caches, mesh, mesh_rules))
    total = 0
    for (path, name, t, paged), spec in zip(_pool_leaves(caches), specs):
        if name in _INDEX_LEAVES:
            continue
        shape = list(t.shape)
        if paged:
            shape[0] -= 1                  # a paged layer's spare hole block
        total += math.prod(shard_shape(shape, spec, mesh, mesh_rules.segments(path))) \
            * t.element_size()
    return total


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

class CacheCodec:
    """One KV-cache storage format: a dict of leaves with time on axis 1
    and a ``len`` leaf, so the slot scatter and the length reset never see
    the codec."""

    name: str = ""

    def init(self, batch: int, max_len: int, n_kv: int, head_dim: int,
             dtype=torch.bfloat16, *, device) -> dict:
        raise NotImplementedError

    def encode(self, k: torch.Tensor, v: torch.Tensor) -> dict:
        """(B, S, H, D) k, v -> dict of encoded leaves (no len)."""
        raise NotImplementedError

    def from_prefill(self, k: torch.Tensor, v: torch.Tensor, max_len: int) -> dict:
        """Encode a prefilled (B, S, H, D) k/v pair into a max_len cache."""
        b, s = k.shape[:2]
        enc = {name: kvq.pad_time(leaf, max_len) for name, leaf in self.encode(k, v).items()}
        enc["len"] = torch.full((b,), s, dtype=torch.int32, device=k.device)
        return enc

    def insert_span(self, cache: dict, k_new, v_new) -> dict:
        """Insert S tokens per sequence, (B, S, H, D) k_new / v_new, from
        position cache['len'] on (the start clamped to [0, T - S], as
        repro's dynamic_update_slice clamps it), in place; ``len`` advances
        by S (the speculative verify's write; S = 1 is a decode step's)."""
        kvq.write_span(cache, self.encode(k_new, v_new), cache["len"])
        cache["len"].add_(k_new.shape[1])
        return cache

    def materialize(self, cache: dict, dtype=torch.bfloat16, *, head_dim=None):
        """The full dequantized (k, v), both (B, T, H, D): tests and checks
        only; decode never materializes a quantized cache. ``head_dim`` is
        needed where the layout rounds D up (binary)."""
        raise NotImplementedError

    def decode_attention(self, q, cache: dict, *, scale=None, impl: str = "auto",
                         q_lens=None):
        """q (B, S, Hq, D) over the cache; every query below cache['len'],
        or query j of slot b below q_lens[b, j] (the speculative verify)."""
        raise NotImplementedError

    def bytes_per_token(self, n_kv: int, head_dim: int) -> int:
        """Resident cache bytes per token per layer (k and v together)."""
        raise NotImplementedError

    # hooks of the bf16 paged decode and the cached prefix's context

    def encoded_leaves(self, cache: dict) -> dict:
        return {k: v for k, v in cache.items() if k not in _INDEX_LEAVES}

    def dequant_block(self, blk: dict, d: int):
        """dict of (B, kb, ...) encoded leaves -> (k, v) (B, kb, H, D)."""
        raise NotImplementedError


class Bf16Codec(CacheCodec):
    """The reference layout, bit for bit the cache the port had before the
    codecs."""

    name = "bf16"

    def init(self, batch, max_len, n_kv, head_dim, dtype=torch.bfloat16, *, device):
        return attn_lib.init_kv_cache(batch, max_len, n_kv, head_dim, dtype, device=device)

    def encode(self, k, v):
        return {"k": k, "v": v}

    def materialize(self, cache, dtype=torch.bfloat16, *, head_dim=None):
        return cache["k"].to(dtype), cache["v"].to(dtype)

    def decode_attention(self, q, cache, *, scale=None, impl="auto", q_lens=None):
        if q_lens is not None:
            # the verify: per-query lengths exist on the fused recurrence
            # only (bf16 passes through dequant_block), as in repro
            return kvd.fused_decode_plain(q, self.encoded_leaves(cache), cache["len"],
                                          lambda blk: self.dequant_block(blk, q.shape[-1]),
                                          scale=scale, q_lens=q_lens)
        return attn_lib.decode_attention(q, cache["k"], cache["v"], kv_len=cache["len"],
                                         scale=scale, impl=impl)

    def dequant_block(self, blk, d):
        # the stored dtype passes through: the paged decode and the context
        # gather read exactly the values the insert wrote
        return blk["k"], blk["v"]

    def bytes_per_token(self, n_kv, head_dim):
        return 2 * n_kv * head_dim * 2


class _QuantCodec(CacheCodec):
    """int8 and binary: one launch of the insert kernel (kernels/kv_quant.py)
    encodes K and V and writes codes and scales where the cache keeps them,
    on the contiguous and the paged pool and at prefill."""

    def from_prefill(self, k, v, max_len):
        enc = kvq.kv_prefill(self.name, k, v, max_len)
        enc["len"] = torch.full((k.shape[0],), k.shape[1], dtype=torch.int32,
                                device=k.device)
        return enc

    def insert_span(self, cache, k_new, v_new):
        """Insert S tokens per sequence from position cache['len'] on, in
        place, through the block table if the cache has one: one launch of
        the insert kernel, then ``len`` gets the kernel's len + S."""
        cache["len"].copy_(kvq.kv_insert(self.name, cache, k_new, v_new, cache["len"],
                                         table=cache.get("table")))
        return cache


class Int8Codec(_QuantCodec):
    """values int8 + per-(token, head) absmax scale bf16."""

    name = "int8"

    def init(self, batch, max_len, n_kv, head_dim, dtype=torch.bfloat16, *, device):
        kw = dict(device=device)
        return {"k_q": torch.zeros((batch, max_len, n_kv, head_dim), dtype=torch.int8, **kw),
                "k_s": torch.zeros((batch, max_len, n_kv), dtype=torch.bfloat16, **kw),
                "v_q": torch.zeros((batch, max_len, n_kv, head_dim), dtype=torch.int8, **kw),
                "v_s": torch.zeros((batch, max_len, n_kv), dtype=torch.bfloat16, **kw),
                "len": torch.zeros((batch,), dtype=torch.int32, **kw)}

    def encode(self, k, v):
        k_q, k_s = kvq.kv_quant_int8(k)
        v_q, v_s = kvq.kv_quant_int8(v)
        return {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}

    def materialize(self, cache, dtype=torch.bfloat16, *, head_dim=None):
        return (kvq.kv_dequant_int8(cache["k_q"], cache["k_s"], dtype=dtype),
                kvq.kv_dequant_int8(cache["v_q"], cache["v_s"], dtype=dtype))

    def decode_attention(self, q, cache, *, scale=None, impl="auto", q_lens=None):
        return kvd.kv_decode_int8(q, cache["k_q"], cache["k_s"], cache["v_q"], cache["v_s"],
                                  cache["len"], table=cache.get("table"), scale=scale,
                                  q_lens=q_lens)

    def dequant_block(self, blk, d):
        return (kvq.kv_dequant_int8(blk["k_q"], blk["k_s"], dtype=torch.float32),
                kvq.kv_dequant_int8(blk["v_q"], blk["v_s"], dtype=torch.float32))

    def bytes_per_token(self, n_kv, head_dim):
        return 2 * n_kv * (head_dim + 2)


class BinaryCodec(_QuantCodec):
    """Sign bits packed 32 to a word + per-(token, head) absmean scale bf16:
    the paper's binary-layer memory trade applied to K/V. Lossy (tolerance
    in tests/test_kvcache.py); greedy decode stays coherent but is not
    token-identical to bf16."""

    name = "binary"

    def init(self, batch, max_len, n_kv, head_dim, dtype=torch.bfloat16, *, device):
        kp, kw = packed_len(head_dim), dict(device=device)
        return {"k_p": torch.zeros((batch, max_len, n_kv, kp), dtype=torch.int32, **kw),
                "k_s": torch.zeros((batch, max_len, n_kv), dtype=torch.bfloat16, **kw),
                "v_p": torch.zeros((batch, max_len, n_kv, kp), dtype=torch.int32, **kw),
                "v_s": torch.zeros((batch, max_len, n_kv), dtype=torch.bfloat16, **kw),
                "len": torch.zeros((batch,), dtype=torch.int32, **kw)}

    def encode(self, k, v):
        k_p, k_s = kvq.kv_quant_binary(k)
        v_p, v_s = kvq.kv_quant_binary(v)
        return {"k_p": k_p, "k_s": k_s, "v_p": v_p, "v_s": v_s}

    def materialize(self, cache, dtype=torch.bfloat16, *, head_dim=None):
        if head_dim is None:
            raise ValueError("BinaryCodec.materialize needs head_dim "
                             "(bit packing rounds D up to whole words)")
        return (kvq.kv_dequant_binary(cache["k_p"], cache["k_s"], head_dim, dtype=dtype),
                kvq.kv_dequant_binary(cache["v_p"], cache["v_s"], head_dim, dtype=dtype))

    def decode_attention(self, q, cache, *, scale=None, impl="auto", q_lens=None):
        return kvd.kv_decode_binary(q, cache["k_p"], cache["k_s"], cache["v_p"], cache["v_s"],
                                    cache["len"], q.shape[-1], table=cache.get("table"),
                                    scale=scale, q_lens=q_lens)

    def dequant_block(self, blk, d):
        return (kvq.kv_dequant_binary(blk["k_p"], blk["k_s"], d, dtype=torch.float32),
                kvq.kv_dequant_binary(blk["v_p"], blk["v_s"], d, dtype=torch.float32))

    def bytes_per_token(self, n_kv, head_dim):
        return 2 * n_kv * (4 * packed_len(head_dim) + 2)


_CODECS = {"bf16": Bf16Codec(), "int8": Int8Codec(), "binary": BinaryCodec()}


def get_codec(name: str = "auto") -> CacheCodec:
    """Resolve a ``ModelConfig.kv_cache`` value ("auto" -> bf16)."""
    return _CODECS[attn_lib.resolve_kv_cache(name)]


# ---------------------------------------------------------------------------
# paged pool: one shared block pool + per-slot block tables
# ---------------------------------------------------------------------------

def init_paged(codec: CacheCodec, n_blocks: int, block_size: int, n_kv: int,
               head_dim: int, max_batch: int, n_pages: int, dtype=torch.bfloat16, *,
               device) -> dict:
    """One layer's paged pool: the codec's leaves over (n_blocks + 1,
    block_size) — to the codec a stack of blocks is a batch of short
    sequences; the last block takes the writes through holes — plus an
    all-hole table and zero lengths."""
    one = codec.init(n_blocks + 1, block_size, n_kv, head_dim, dtype, device=device)
    one.pop("len")
    one["table"] = torch.full((max_batch, n_pages), n_blocks, dtype=torch.int32,
                              device=device)
    one["len"] = torch.zeros((max_batch,), dtype=torch.int32, device=device)
    return one


def _n_blocks(cache: dict) -> int:
    """Physical blocks a paged layer's table addresses (every encoded leaf's
    axis 0 less the spare block, which is also the id a hole writes to)."""
    return next(v for k, v in cache.items() if k not in _INDEX_LEAVES).shape[0] - 1


def paged_update_slots(pool: list, rows: torch.Tensor, lens: torch.Tensor,
                       slots: torch.Tensor) -> list:
    """Rebind slots' block tables and lengths (admission, eviction), in
    place. rows (G, n_pages) physical ids (holes >= n_blocks), lens (G,),
    slots (G,); slots >= max_batch drop, as in cache_insert_slots."""
    keep = _kept(slots, pool[0]["len"].shape[0])
    dst, rows, lens = slots[keep].to(torch.int64), rows[keep], lens[keep]
    for c in pool:
        c["table"][dst] = rows.to(torch.int32)
        c["len"][dst] = lens.to(torch.int32)
    return pool


def paged_insert_prefill(pool: list, new: list, dest_pages: torch.Tensor) -> list:
    """Scatter a prefill's codec-encoded caches into physical blocks.

    ``new`` is the contiguous prefill cache (per layer, leaves (G, T, ...)
    with T = n_pages * block_size); row g's page i goes to block
    dest_pages[g, i]. Holes (>= n_blocks) go to the spare block, unread:
    that is how the engine skips the pages a cached prefix covers and pads
    prefill groups. ``new``'s lengths are dropped: slot lengths belong to
    paged_update_slots."""
    blocks = torch.clamp(dest_pages, max=_n_blocks(pool[0])).to(torch.int64).reshape(-1)
    for dst_layer, src_layer in zip(pool, new):
        for name, src in src_layer.items():
            if name == "len":
                continue
            dst = dst_layer[name]
            bs = dst.shape[1]
            dst[blocks] = src.reshape(-1, bs, *src.shape[2:]).to(dst.dtype)
    return pool


def paged_insert_span(cache: dict, k_new, v_new, codec: CacheCodec) -> dict:
    """Per-layer insert of S tokens a slot, in place: encode them and write
    token j at (table[b, p // bs], p % bs), p = len + j; ``len`` advances by
    S. Free slots meet table holes, and positions past the table's pages
    meet none: both write to the spare block (repro drops them). int8 and
    binary: the codec's insert kernel; bf16: a torch scatter."""
    if codec.name != "bf16":
        return codec.insert_span(cache, k_new, v_new)
    kvq.write_paged(cache, codec.encode(k_new, v_new), cache["len"], cache["table"])
    cache["len"].add_(k_new.shape[1])
    return cache


def paged_decode_attention(q: torch.Tensor, cache: dict, codec: CacheCodec, *,
                           scale: float | None = None, q_lens=None) -> torch.Tensor:
    """Attention through the block table, every query below its slot's
    length or, with ``q_lens`` (B, S), query j of slot b below q_lens[b, j].
    int8 and binary: the codec's decode, whose kernel walks the table as
    repro's scan does, one page at a time, and reads only the pages below
    each slot's length. bf16: every page of every slot is gathered in one
    indexed read (holes clamp to the spare block, whose columns lie past
    the slot's length, so they mask out) and the plain recurrence runs over
    that contiguous view."""
    if codec.name != "bf16":
        return codec.decode_attention(q, cache, scale=scale, q_lens=q_lens)
    return kvd.fused_decode_plain(q, codec.encoded_leaves(cache), cache["len"],
                                  lambda blk: codec.dequant_block(blk, q.shape[-1]),
                                  table=cache["table"], scale=scale, q_lens=q_lens)


def gather_prefix_context(pool: list, ctx_pages: torch.Tensor, codec: CacheCodec,
                          head_dim: int) -> list:
    """Cached-prefix K/V for a suffix prefill: per layer {"k", "v"}
    (G, P * block_size, Hkv, D), decoded through the codec. ctx_pages
    (G, P) are block ids in range (rows with fewer matched pages repeat
    block 0, masked later by ctx_len)."""
    out = []
    for c in pool:
        view = {name: kvd.gather_pages(leaf, ctx_pages)
                for name, leaf in codec.encoded_leaves(c).items()}
        k, v = codec.dequant_block(view, head_dim)
        out.append({"k": k, "v": v})
    return out
