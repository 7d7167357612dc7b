"""Per-request sampling streams, drawing the bits JAX draws (port of the
sampling in repro/serving/engine.py:405-415, :534-553 and
repro/serving/spec.py:125-133, :181-190).

Row r of a sampled step draws its token from

    categorical(fold_in(fold_in(PRNGKey(seed), rid), step), logits / t)

so a request's output is a function of (params, prompt, seed, rid) alone.
This module ports what that needs from JAX 0.9 (jax/_src/prng.py,
jax/_src/random.py) with its default ``jax_threefry_partitionable=True``:

  threefry2x32   the 20-round Threefry-2x32 hash (prng.py:883)
  prng_key       a seed -> the key (0, seed) (threefry_seed, 64-bit seeds
                 split into (high, low) words)
  fold_in        key, data -> threefry2x32(key, (0, data))
  split          key -> num keys, key i = threefry2x32(key, (0, i))
                 (_threefry_split_foldlike: the same words as fold_in(key, i))
  random_bits    32 bits per element: the hash of the 64-bit counter iota
                 split into (high, low) words, the two output words XORed
                 (8 bits: the low byte of that, for bf16)
  uniform        the top mantissa bits under the exponent of 1.0, minus 1,
                 scaled into [minval, maxval)
  gumbel         -log(-log(uniform(tiny, 1)))  (mode "low", JAX's default)
  categorical    argmax(gumbel + logits), the first maximum; one key per
                 row, or (``categorical_shared``) one key for a whole batch,
                 as the bucket engine draws (serving/bucket.py)

Words are int64 tensors holding 32-bit values (torch on the CPU has no
uint32 right shift; ROADMAP C), masked after each add and shift. Every
function takes a batch of keys, (..., 2), one per row, so one call draws a
whole step's rows on the logits' device with no host loop and no sync, and
a CUDA graph can hold it.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 of the counter words (x0, x1) under ``key`` (..., 2);
    every word an int64 tensor of 32-bit values, key[..., 0] broadcast
    with x0. Returns the two output words."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int, *, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) for 0 <= seed < 2**64: (2,) int64."""
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return torch.tensor([seed >> 32, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor | int) -> torch.Tensor:
    """jax.random.fold_in for keys (..., 2) and 32-bit data (...,) (or one
    int for every key): the hash of the counter (0, data). -> (..., 2)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK
    data = data.expand(key.shape[:-1])
    y0, y1 = threefry2x32(key, torch.zeros_like(data), data)
    return torch.stack([y0, y1], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """jax.random.split in the partitionable layout: key (2,) -> (num, 2),
    key i the hash of the counter (0, i) (i < 2**32)."""
    counts = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key.expand(num, 2), torch.zeros_like(counts), counts)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: tuple[int, ...], bit_width: int = 32) -> torch.Tensor:
    """jax.random.bits in the partitionable layout: element i of ``shape``
    (row-major) hashes the counter (i >> 32, i & MASK); the result is the
    XOR of the two output words, cut to ``bit_width`` (8 or 32) bits. Keys
    (..., 2) give (..., *shape)."""
    if bit_width not in (8, 32):
        raise ValueError(f"random_bits draws 8 or 32 bits, not {bit_width}")
    n = 1
    for d in shape:
        n *= d
    iota = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    per_row = key.reshape(*key.shape[:-1], *([1] * len(shape)), 2)
    y0, y1 = threefry2x32(per_row, iota >> 32, iota & MASK)
    bits = y0 ^ y1
    return bits & 0xFF if bit_width == 8 else bits


def uniform(key: torch.Tensor, shape: tuple[int, ...], dtype=torch.float32,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform in f32 (32 random bits, the top 23 as mantissa) or
    bf16 (8 random bits, the top 7), every step rounded in ``dtype``."""
    if dtype == torch.float32:
        bits = random_bits(key, shape, 32)
        one = (bits >> 9) | 0x3F800000
        floats = one.to(torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.bfloat16:
        bits = random_bits(key, shape, 8)
        one = (bits >> 1) | 0x3F80
        floats = one.to(torch.int16).view(torch.bfloat16) - 1.0
    else:
        raise TypeError(f"uniform draws f32 or bf16, not {dtype}")
    # filled on the device (no copy from the host, so a graph can hold it)
    lo = torch.full((), minval, dtype=dtype, device=key.device)
    hi = torch.full((), maxval, dtype=dtype, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: tuple[int, ...], dtype=torch.float32) -> torch.Tensor:
    """jax.random.gumbel, mode "low": -log(-log(u)), u uniform in
    [tiny, 1)."""
    u = uniform(key, shape, dtype, minval=torch.finfo(dtype).tiny, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical over the last axis: keys (..., 2) and logits
    (..., V) -> (...,) int64, the first maximum of gumbel + logits."""
    g = gumbel(key, (logits.shape[-1],), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def categorical_shared(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """jax.random.categorical(key, logits) for one key (2,) and logits
    (..., V): the gumbel noise of the whole array from that key, row-major
    (..., V); -> (...,) int64."""
    g = gumbel(key, tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=-1)


def stream_keys(seed_key: torch.Tensor, rids: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """The per-request keys fold_in(fold_in(seed_key, rid), step): rids and
    steps (...,) -> (..., 2)."""
    rids = rids.to(torch.int64)
    per_rid = fold_in(seed_key.expand(*rids.shape, 2), rids)
    return fold_in(per_rid, steps.to(torch.int64).expand(rids.shape))


def sample_rows(logits: torch.Tensor, seed_key: torch.Tensor, rids: torch.Tensor,
                steps: torch.Tensor, temperature: float) -> torch.Tensor:
    """Row r's token from its request's stream: categorical(fold_in(
    fold_in(seed_key, rids[r]), steps[r]), logits[r] / t). logits (..., V),
    rids and steps (...,) -> (...,) int32."""
    keys = stream_keys(seed_key, rids, steps)
    return categorical(keys, logits / temperature).to(torch.int32)


def pick(logits: torch.Tensor, temperature: float, seed_key: torch.Tensor,
         rids: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """The engine's token pick on the device: the first maximum of each
    row (temperature <= 0), or row r's draw from its request's (rids[r],
    steps[r]) stream. -> (...,) int32."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return sample_rows(logits, seed_key, rids, steps, temperature)
