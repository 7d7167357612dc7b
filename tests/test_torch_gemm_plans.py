"""The host side of the B1 and B6 CUDA kernels, on the CPU.

* ``binary_matmul.plan`` and ``bf16_matmul.plan`` (pure functions of the
  shape and the SM count): the grid the kernel derives from a plan covers
  every output exactly once, and its K split covers the K range exactly
  once, in 1, 2, 4 or 8 chunks (one thread block cluster) cut at stage
  boundaries. At the MNIST float shapes B6's grid has at least one block
  per SM; B1 splits only where the sweeps on the H100 found a split faster
  (the spec draft's K = 2560), since one B1 call at the MNIST shapes is one
  round trip to memory whatever its grid (PERF.md section 6).
* The identity the B1 kernel computes with the tensor cores' AND-popcount,
  K - 2 (Pa + Pw) + 4 popc(pa & pw), equals the XNOR count of
  ``binary_matmul_plain`` and of repro's oracle bit for bit, with the pad
  bits of a last partial word set and with zero words appended past Kp
  (the kernel's zero-filled stages).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core.binarize import pack_bits, packed_len  # noqa: E402
from repro_torch.kernels import bf16_matmul as bfm  # noqa: E402
from repro_torch.kernels import binary_matmul as bm  # noqa: E402
from repro_torch.kernels.ksplit import cheapest_split, splits_for  # noqa: E402
from repro_torch.kernels.ref import popcount32  # noqa: E402

torch.set_num_threads(2)


def _covered_once(m: int, n: int, bm_: int, bn_: int) -> bool:
    """The (M tiles, N tiles) grid of bm_ x bn_ blocks, as the kernels
    derive it (block (y, z) takes rows [z bm_, z bm_ + bm_) and columns
    [y bn_, y bn_ + bn_), masked to M and N), covers each output once."""
    hits = np.zeros((m, n), np.int32)
    for z in range(-(-m // bm_)):
        for y in range(-(-n // bn_)):
            hits[z * bm_:(z + 1) * bm_, y * bn_:(y + 1) * bn_] += 1
    return bool((hits == 1).all())


def _split_ranges(length: int, kchunk: int) -> list[tuple[int, int]]:
    """[begin, end) of each block of a cluster, as the kernels derive it:
    block x takes [x kchunk, min((x + 1) kchunk, length))."""
    return [(x * kchunk, min((x + 1) * kchunk, length)) for x in range(-(-length // kchunk))]


def _check_split(length: int, kchunk: int, stage: int) -> int:
    assert kchunk > 0
    ranges = _split_ranges(length, kchunk)
    assert [i for b, e in ranges for i in range(b, e)] == list(range(length))
    assert all(e > b for b, e in ranges)
    assert len(ranges) in (1, 2, 4, 8)
    assert len(ranges) == 1 or kchunk % stage == 0
    return len(ranges)


# (M, N, K, SMs): the MNIST hidden layers at batch 1 / 128 / 256 / 512, the
# ragged K of the card tests (40, 100, 384), the spec draft (8, 6912,
# 2560), K ranges of 8 stages (2048) and of 63 words (2016), other SM counts
XNOR_PLAN_CASES = [(1, 1024, 1024, 132), (128, 1024, 1024, 132), (256, 1024, 1024, 132),
                   (512, 1024, 1024, 132), (8, 24, 40, 132), (32, 48, 100, 132),
                   (64, 64, 384, 132), (8, 6912, 2560, 132), (40, 72, 2048, 132),
                   (77, 130, 2016, 132), (8, 6912, 2560, 114), (1, 8, 16384, 8)]
MNIST_XNOR = [(m, 1024, 1024) for m in (1, 128, 256, 512)]


@pytest.mark.parametrize("m,n,k,sms", XNOR_PLAN_CASES)
def test_binary_matmul_plan_covers_outputs_and_k_once(m, n, k, sms):
    kchunk = bm.plan(m, n, k, sms)
    assert _covered_once(m, n, *bm.TILE)
    splits = _check_split(packed_len(k), kchunk, bm.STAGE_WORDS)
    if (m, n, k) in MNIST_XNOR:
        assert splits == 1             # 4 stages: a split only adds its reduction
    if (m, n, k) == (8, 6912, 2560) and sms == 132:
        assert splits == 2             # 10 stages: 2 chunks ran fastest
    # the split the plan picks is one of those its model costs
    assert splits in splits_for(-(-packed_len(k) // bm.STAGE_WORDS))


# (M, N, K, SMs): the MNIST float layers at batch 256 (fc0 784 -> 1024,
# fc1 / fc2 1024 -> 1024, fc3 1024 -> 10) and at batch 1, the chip_smoke
# row 256 x 1024 -> 512, the card tests' edges (K 16 / 100 / 99 / 998,
# N 8 / 10 / 16 / 7), and other SM counts
BF16_PLAN_CASES = [(256, 1024, 784, 132), (256, 1024, 1024, 132), (256, 10, 1024, 132),
                   (1, 1024, 784, 132), (1, 10, 1024, 132), (256, 512, 1024, 132),
                   (64, 8, 16, 132), (77, 130, 100, 132), (5, 7, 99, 132),
                   (40, 70, 998, 132), (33, 16, 784, 132), (256, 1024, 784, 114),
                   (2048, 2048, 4096, 132)]
MNIST_FLOAT = [(256, 1024, 784), (256, 1024, 1024), (256, 10, 1024)]


@pytest.mark.parametrize("m,n,k,sms", BF16_PLAN_CASES)
def test_bf16_matmul_plan_covers_outputs_and_k_once(m, n, k, sms):
    design, kchunk = bfm.plan(m, n, k, sms)
    assert design == (bfm.SMALL if m <= 16 or n <= 16 else bfm.LARGE)
    bm_, bn_ = bfm.TILES[design]
    assert _covered_once(m, n, bm_, bn_)
    splits = _check_split(k, kchunk, bfm.STAGE_K)
    if (m, n, k) in MNIST_FLOAT and sms == 132:
        assert -(-m // bm_) * -(-n // bn_) * splits >= sms     # a block per SM


def test_splits_for_cut_whole_stages():
    """Every cluster size offered cuts ``units`` stages into exactly that
    many chunks of ceil(units / s) stages, the last possibly shorter."""
    for units in range(1, 40):
        assert 1 in splits_for(units)
        for s in splits_for(units):
            assert s in (1, 2, 4, 8)
            assert len(_split_ranges(units, -(-units // s))) == s


# (tiles, stages, slots an SM, split cost, want): B6's costs at fc0 (64
# tiles, 13 stages), fc3 (32 SMALL tiles, 16) and fc1 (64, 16: 8 chunks
# would need a second round); B1's at the MNIST hidden layer (128 tiles, 4
# stages) and the spec draft (216, 10): the fastest splits of the sweeps
SPLIT_COSTS = [(64, 13, 3, 1, 4), (32, 16, 3, 1, 8), (64, 16, 3, 1, 4), (128, 4, 4, 3, 1),
               (216, 10, 4, 3, 2)]


@pytest.mark.parametrize("tiles,units,slots,cost,want", SPLIT_COSTS)
def test_cheapest_split_costs_rounds_and_stages(tiles, units, slots, cost, want):
    assert cheapest_split(tiles, units, 132, slots, cost) == want


def _signs(rows: int, k: int, rng) -> torch.Tensor:
    return torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))


# (M, N, K): K 40 / 100 / 384 / 1024 (Kp 2 / 4 / 12 / 32; 24, 28, 0 and 0 pad
# bits), with ragged M and N
@pytest.mark.parametrize("m,n,k", [(5, 7, 40), (33, 17, 100), (16, 8, 384), (9, 40, 1024)])
@pytest.mark.parametrize("extra_words", [0, 3])
def test_and_popc_identity_equals_xnor_count(m, n, k, extra_words):
    rng = np.random.default_rng(k + m)
    pa, pw = pack_bits(_signs(m, k, rng)), pack_bits(_signs(n, k, rng))
    want = bm.binary_matmul_plain(pa, pw, k)
    # the reference's oracle, on the same words as uint32
    gold = np.asarray(j_ref.binary_matmul_packed_ref(
        jnp.asarray(pa.numpy().view(np.uint32)), jnp.asarray(pw.numpy().view(np.uint32)), k))
    np.testing.assert_array_equal(want.numpy(), gold)
    # the kernel's zero-filled words past Kp, in both operands
    za, zw = (torch.cat([x, torch.zeros(x.shape[0], extra_words, dtype=torch.int32)], dim=1)
              for x in (pa, pw))
    p_a = popcount32(za).sum(dim=1, dtype=torch.int32)          # pad bits included
    p_w = popcount32(zw).sum(dim=1, dtype=torch.int32)
    and_ = popcount32(za[:, None, :] & zw[None, :, :]).sum(dim=2, dtype=torch.int32)
    got = k - 2 * (p_a[:, None] + p_w[None, :]) + 4 * and_
    assert got.dtype == torch.int32
    assert torch.equal(got, want)
