"""How the GEMM kernels (B1, B2, B6) cut their K range over a thread block
cluster, on the host.

A kernel's K range is a whole number of stages (``units``); a split cuts
it into ``s`` chunks of ceil(units / s) stages, one block of a cluster of
``s`` blocks each, whose partial tiles the cluster adds in distributed
shared memory. The cost model below was fitted per kernel to sweeps of
every split on the H100 (PERF.md section 6)."""

from __future__ import annotations

import functools

import torch

# cluster sizes that schedule well: clusters of 3, 5 or 7 blocks ran
# slower than their share of the work on the H100 (PERF.md, B2's sweeps)
CLUSTERS = (1, 2, 4, 8)


def splits_for(units: int) -> list[int]:
    """The cluster sizes that cut ``units`` stages into exactly that many
    chunks of whole stages."""
    return [s for s in CLUSTERS if s <= units and -(-units // -(-units // s)) == s]


def cheapest_split(tiles: int, units: int, n_sms: int, slots: int, split_cost: int) -> int:
    """The split with the least (rounds of ``tiles`` x s blocks over the
    card, ``slots`` blocks an SM) x (stages a block runs + the reduction,
    ``split_cost`` stages per doubling); the fewer chunks on a tie."""
    def cost(s: int) -> int:
        rounds = -(-tiles * s // (slots * n_sms))
        return rounds * (-(-units // s) + split_cost * (s.bit_length() - 1))
    return min(splits_for(units), key=cost)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, which the plans spread their blocks over."""
    return torch.cuda.get_device_properties(device).multi_processor_count
