"""The host side and the epilogue of the B5 CUDA kernel, on the CPU.

* ``hybrid_dense.plan`` (a pure function of the shape and the SM count):
  its K split covers the K range exactly once, in 1, 2, 4 or 8 chunks (one
  thread block cluster) cut at stage boundaries, and the grid the kernel
  derives (blocks of 32 rows by two 32-column words, 2 x 2 warps of 16
  rows by one word, a word column past N idle) covers every output word
  exactly once.
* The epilogue's lane maps, mirrored in numpy: unsplit, lane 4 g + t holds
  rows g and g + 8 and, in n8 tile j, columns 8 j + 2 t + e, sets bit
  8 j + 2 t + e, the quad ORs its words and lanes t = 0 / 1 store rows g /
  g + 8; split, each rank finishes whole words (a row of one word column)
  and lane i gives bit i (a ballot). Both equal ``pack_bits(y >= 0)`` bit
  for bit, with +0.0 and -0.0 in y.
* The split epilogue's arithmetic: the chunks' partials 4 AND - 2 (Pa +
  Pw), summed in any order, plus K, then the affine in two roundings and
  the sign, equal ``hybrid_dense_plain`` and repro's ``hybrid_dense_ref``,
  where y is exactly +0.0 and -0.0 too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core.binarize import pack_bits, packed_len  # noqa: E402
from repro_torch.kernels import hybrid_dense as hd  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul_plain  # noqa: E402
from repro_torch.kernels.ksplit import splits_for  # noqa: E402
from repro_torch.kernels.ref import popcount32  # noqa: E402

torch.set_num_threads(2)

WM, WN = 2, 2      # the kernel's warps: WM of 16 rows by WN of one word
# repro's oracle, compiled once per shape (its ops one by one cost ~0.5 s a shape)
J_HYBRID = jax.jit(j_ref.hybrid_dense_ref, static_argnums=4)


def _chunks(kp: int, kchunk: int) -> list[tuple[int, int]]:
    """[begin, end) of each block of a cluster, as the kernel derives it:
    block x takes words [x kchunk, min((x + 1) kchunk, Kp))."""
    return [(x * kchunk, min((x + 1) * kchunk, kp)) for x in range(-(-kp // kchunk))]


# (M, N, K, SMs): the chip_smoke cases (the MNIST hidden layers at batch 1 /
# 128 / 256 / 512, ragged M 77, ragged K 100, K 384 (Kp 12), the long K
# 2560), the card tests' edges (M 16 / 17 / 33, K 2048 / 2016), other SM
# counts
PLAN_CASES = [(1, 1024, 1024, 132), (128, 1024, 1024, 132), (256, 1024, 1024, 132),
              (512, 1024, 1024, 132), (77, 1024, 1024, 132), (32, 64, 100, 132),
              (64, 1024, 384, 132), (8, 1024, 2560, 132), (16, 64, 1024, 132),
              (17, 64, 1024, 132), (33, 96, 1024, 132), (40, 64, 2048, 132),
              (77, 96, 2016, 132), (8, 1024, 2560, 114), (1, 32, 16384, 8)]
MNIST = [(m, 1024, 1024) for m in (1, 128, 256, 512)]


@pytest.mark.parametrize("m,n,k,sms", PLAN_CASES)
def test_plan_covers_k_and_words_once(m, n, k, sms):
    kp = packed_len(k)
    kchunk = hd.plan(m, n, k, sms)
    chunks = _chunks(kp, kchunk)
    assert [i for b, e in chunks for i in range(b, e)] == list(range(kp))
    assert len(chunks) in (1, 2, 4, 8) and all(e > b for b, e in chunks)
    assert len(chunks) == 1 or kchunk % hd.STAGE_WORDS == 0
    assert len(chunks) in splits_for(-(-kp // hd.STAGE_WORDS))
    if (m, n, k) in MNIST:
        assert len(chunks) == 1        # 4 stages: a split only adds its reduction
    if (m, n, k) == (8, 1024, 2560) and sms == 132:
        assert len(chunks) == 2
    # grid (ceil(N / 64) word pairs, ceil(M / 32) tiles): block (y, z)
    # stores rows [32 z, 32 z + 32) below M of words 2 y, 2 y + 1 below N / 32
    assert hd.TILE == (16 * WM, 32 * WN)
    hits = np.zeros((m, n // 32), np.int32)
    for z in range(-(-m // hd.TILE[0])):
        for y in range(-(-n // hd.TILE[1])):
            hits[z * hd.TILE[0]:(z + 1) * hd.TILE[0], WN * y:WN * (y + 1)] += 1
    assert (hits == 1).all()


def _signed_y(rows: int, cols: int, rng) -> np.ndarray:
    y = rng.standard_normal((rows, cols)).astype(np.float32)
    y[rng.random((rows, cols)) < 0.2] = 0.0
    y[rng.random((rows, cols)) < 0.2] = -0.0
    return y


def _unsplit_words(y: np.ndarray) -> np.ndarray:
    """The unsplit epilogue's stores for a (M, N) y, lane by lane."""
    m, n = y.shape
    out = np.full((m, n // 32), -1, np.int64)      # -1: never stored
    for z in range(-(-m // (16 * WM))):
        for by in range(-(-n // (32 * WN))):
            for warp in range(WM * WN):
                wm, wn = divmod(warp, WN)
                r0, word = 16 * WM * z + 16 * wm, WN * by + wn
                if word >= n // 32:
                    continue                        # an idle word column past N
                lanes = np.zeros((32, 2), np.uint32)        # (lane, half) bits
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    for j in range(4):
                        for e in range(2):
                            c = 8 * j + 2 * t + e
                            for h in range(2):
                                r = r0 + g + 8 * h
                                if r < m and y[r, 32 * word + c] >= 0:
                                    lanes[lane, h] |= np.uint32(1 << c)
                for xor in (1, 2):                  # the quad's OR, two shuffles
                    lanes = lanes | lanes[np.arange(32) ^ xor]
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    r = r0 + g + 8 * t
                    if t < 2 and r < m:
                        assert out[r, word] == -1
                        out[r, word] = lanes[lane, t]
    return out


def _split_words(y: np.ndarray, nranks: int) -> np.ndarray:
    """The split epilogue's stores: the block's words u = (row, word
    column) = divmod(u, WN); rank q's warp w finishes words q WM WN + w,
    stepping nranks WM WN, lane i voting for column i."""
    m, n = y.shape
    warps = WM * WN
    out = np.full((m, n // 32), -1, np.int64)
    for z in range(-(-m // (16 * WM))):
        for by in range(-(-n // (32 * WN))):
            for rank in range(nranks):
                for warp in range(warps):
                    for u in range(rank * warps + warp, 16 * WM * WN, nranks * warps):
                        r, wc = divmod(u, WN)
                        row, word = 16 * WM * z + r, WN * by + wc
                        if row >= m:
                            break
                        if word >= n // 32:
                            continue
                        votes = y[row, 32 * word:32 * word + 32] >= 0
                        assert out[row, word] == -1
                        out[row, word] = int(sum(1 << i for i in range(32) if votes[i]))
    return out


@pytest.mark.parametrize("m,n", [(16, 32), (40, 96), (33, 128)])
def test_epilogue_lane_maps_equal_pack_bits(m, n):
    y = _signed_y(m, n, np.random.default_rng(m + n))
    want = pack_bits(torch.from_numpy(y)).numpy().view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(_unsplit_words(y), want)
    for nranks in (2, 4, 8):
        np.testing.assert_array_equal(_split_words(y, nranks), want)


def _scale_shift(n: int, rng, signed_zero: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """Random scale and shift, or +-1 with shift -0.0 (y = +-0.0 where the
    dot is 0) and -+2 (y = +0.0 where it is 2)."""
    if signed_zero:
        return (torch.tensor([1.0, -1.0, 1.0, -1.0]).repeat(n // 4),
                torch.tensor([-0.0, -0.0, -2.0, 2.0]).repeat(n // 4))
    return (torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1 + 0.5),
            torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1))


# (M, N, K): Kp 4 (28 pad bits), Kp 12, the MNIST width, 63 words, K 2560
@pytest.mark.parametrize("m,n,k", [(9, 32, 100), (40, 64, 384), (64, 64, 1024),
                                   (17, 32, 2016), (8, 64, 2560)])
@pytest.mark.parametrize("signed_zero", [False, True])
def test_split_epilogue_equals_plain_and_repro(m, n, k, signed_zero):
    rng = np.random.default_rng(m + n + k)
    pa = pack_bits(torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)))
    pw = pack_bits(torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)))
    scale, shift = _scale_shift(n, rng, signed_zero)
    want = hd.hybrid_dense_plain(pa, pw, scale, shift, k)
    gold = np.asarray(J_HYBRID(
        jnp.asarray(pa.numpy().view(np.uint32)), jnp.asarray(pw.numpy().view(np.uint32)),
        jnp.asarray(scale.numpy()), jnp.asarray(shift.numpy()), k))
    np.testing.assert_array_equal(want.numpy().view(np.uint32), gold)
    if signed_zero:
        y = binary_matmul_plain(pa, pw, k).float() * scale + shift
        assert ((y == 0) & torch.signbit(y)).any() and ((y == 0) & ~torch.signbit(y)).any()
    kp = pa.shape[1]
    units = -(-kp // hd.STAGE_WORDS)
    for s in splits_for(units):
        # each chunk's partial over whole stages, words past Kp zero-filled
        kchunk = hd.STAGE_WORDS * -(-units // s)
        width = -(-kp // kchunk) * kchunk
        za, zw = (torch.cat([x, torch.zeros(x.shape[0], width - kp, dtype=torch.int32)], 1)
                  for x in (pa, pw))
        parts = []
        for b in range(0, width, kchunk):
            a, w = za[:, b:b + kchunk], zw[:, b:b + kchunk]
            p_a = popcount32(a).sum(1, dtype=torch.int32)
            p_w = popcount32(w).sum(1, dtype=torch.int32)
            p_and = popcount32(a[:, None, :] & w[None, :, :]).sum(-1, dtype=torch.int32)
            parts.append(4 * p_and - 2 * (p_a[:, None] + p_w[None, :]))
        for order in (range(len(parts)), rng.permutation(len(parts))):
            dot = torch.full((m, n), k, dtype=torch.int32)
            for q in order:
                dot = dot + parts[q]
            y = dot.float() * scale + shift           # two roundings, as __fmul_rn, __fadd_rn
            assert torch.equal(pack_bits(y), want), (s, list(order))
