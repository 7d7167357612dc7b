"""The port's kernel modules against repro's.

* int8: ``int8_matmul_plain`` equals repro's ``int8_matmul_pallas``
  (interpret mode) and ``binary_matmul_packed_ref`` exactly — integer dots
  of +-1 vectors have one right answer, so there is no tolerance.
* binary dense: ``ops.binary_dense(mode="int8")`` on the latent weight,
  and ``ops.binary_dense_packed`` on its packed words, equal repro's
  ``ops.binary_dense`` exactly in f32 and bitwise in bf16 (both round the
  same int32 to bf16); so does ``mode="xnor"``.
* flash: ``flash_attention_plain`` matches repro's ``flash_attention_pallas``
  (interpret mode, 16 x 16 blocks so both grid axes iterate) within
  tests/test_attention.py's TOLS: 2e-5 in f32 (the online softmax sums in
  another order), 3e-2 in bf16 (repro's kernel also rounds p to bf16 before
  p @ v; the plain version keeps it in f32).
* On a CPU tensor each wrapper runs its plain version and launches nothing.

The CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py, which imports no jax (the machine with the card
has none).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.binarize import pack_bits as j_pack_bits  # noqa: E402
from repro.core.binarize import pack_signs_int8 as j_signs  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.kernels.int8_matmul import int8_matmul_pallas  # noqa: E402
from repro_torch.core.binarize import pack_bits, pack_signs_int8  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.int8_matmul import (int8_matmul,  # noqa: E402
                                             int8_matmul_plain)
from repro_torch.kernels.int8_matmul import plan as int8_plan  # noqa: E402

torch.set_num_threads(2)

SHAPES = [(128, 256, 128), (256, 1024, 512), (64, 512, 256)]   # (M, K, N)
RAGGED = [(5, 96, 40), (1, 32, 1), (77, 160, 130)]
TOLS = {np.float32: 2e-5, "bfloat16": 3e-2}


def _ab(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


def _i32(u32) -> torch.Tensor:
    return torch.from_numpy(np.array(u32).view(np.int32))


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_plain_equals_pallas_and_ref(m, k, n):
    a, w = _ab(m, k, n, seed=1)
    pw = j_pack_bits(jnp.asarray(w))
    gold = np.asarray(int8_matmul_pallas(j_signs(jnp.asarray(a)), pw, interpret=True))
    np.testing.assert_array_equal(
        gold, np.asarray(j_ref.binary_matmul_packed_ref(j_pack_bits(jnp.asarray(a)), pw, k)))
    got = int8_matmul_plain(pack_signs_int8(torch.from_numpy(a)), _i32(pw))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), gold)
    # the port's XNOR-popcount oracle (SWAR bit count) agrees too
    np.testing.assert_array_equal(
        ref.binary_matmul_packed_ref(pack_bits(torch.from_numpy(a)), _i32(pw), k).numpy(),
        gold)


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_int8_wrapper_on_cpu_is_plain_for_ragged_shapes(m, k, n):
    """M and N need not divide any block; repro's kernel asserts that they
    do, so the oracle here is the int8 dot of the unpacked signs."""
    a, w = _ab(m, k, n, seed=2)
    ta = pack_signs_int8(torch.from_numpy(a))
    tw = pack_bits(torch.from_numpy(w))
    before = int8_matmul.launches
    got = int8_matmul(ta, tw)
    assert int8_matmul.launches == before          # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), int8_matmul_plain(ta, tw).numpy())
    np.testing.assert_array_equal(
        got.numpy(), ref.int8_matmul_ref(ta, pack_signs_int8(torch.from_numpy(w))).numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ref.int8_matmul_ref(j_signs(jnp.asarray(a)),
                                                      j_signs(jnp.asarray(w)))))


def test_int8_wrapper_rejects_bad_k():
    with pytest.raises(ValueError):
        int8_matmul(torch.ones(2, 40, dtype=torch.int8), torch.zeros(3, 1, dtype=torch.int32))


# (M, N, K, SMs): the serving path's decode shapes (bin_in, bin_out, at
# M = 1, 8, 16) and a prefill one, the switch at M = 16 / 17, K of one
# stage (32, 96), K that the split leaves ragged (6784: 53 stages), packed
# rows that are not whole stages (6944: 217 words), and other SM counts
SERVING_NK = [(6912, 2560), (2560, 6912)]
PLAN_CASES = [(8, 6912, 2560, 132), (8, 2560, 6912, 132), (1, 2560, 6912, 132),
              (16, 6912, 2560, 132), (17, 6912, 2560, 132), (1024, 2560, 6912, 132),
              (1024, 6912, 2560, 132), (2048, 2560, 6912, 132), (128, 6912, 2560, 132),
              (16, 72, 32, 132), (3, 2560, 96, 132), (8, 100, 6784, 132),
              (8, 130, 6944, 132), (8, 2560, 6912, 114), (8, 6912, 2560, 8)]


def _split_ranges(k: int, kchunk: int) -> list[tuple[int, int]]:
    """The packed-word range [begin, end) of each block of a cluster, as
    csrc/int8_matmul.cu derives it: block x takes [x kchunk, min((x + 1)
    kchunk, K/32)), for x < ceil((K/32) / kchunk)."""
    kp = k // 32
    return [(x * kchunk, min((x + 1) * kchunk, kp)) for x in range(-(-kp // kchunk))]


@pytest.mark.parametrize("m,n,k,sms", PLAN_CASES)
def test_int8_plan_splits_cover_k_once(m, n, k, sms):
    """The host's plan for the B2 kernel: the decode design up to M = 16,
    the prefill design above; a K split whose chunks (as the kernel derives
    them from the chunk length) cover every packed word exactly once, in
    1, 2, 4 or 8 chunks (one thread block cluster), cut at 4-word stage
    boundaries; at the serving decode shapes, at least two blocks per SM."""
    design, kchunk = int8_plan(m, n, k, sms)
    assert design == (1 if m <= 16 else 0)
    kp = k // 32
    assert kchunk > 0
    ranges = _split_ranges(k, kchunk)
    assert [w for b, e in ranges for w in range(b, e)] == list(range(kp))
    assert all(e > b for b, e in ranges)
    assert len(ranges) in (1, 2, 4, 8)
    assert len(ranges) == 1 or kchunk % 4 == 0
    if (n, k) in SERVING_NK and sms == 132 and m <= 16:
        assert len(ranges) * -(-n // 64) >= 2 * sms


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lead", [(6,), (2, 3)])
def test_binary_dense_int8_matches_repro(dtype, lead):
    rng = np.random.default_rng(3)
    k, n = 64, 96
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    want = np.asarray(j_ops.binary_dense(jx, jnp.asarray(w), mode="int8"))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    tw = torch.from_numpy(w)
    got = ops.binary_dense(tx, tw, mode="int8")
    assert got.dtype == tx.dtype and tuple(got.shape) == (*lead, n)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))
    packed = ops.binary_dense_packed(tx, pack_bits(tw.T), mode="int8")
    assert packed.dtype == tx.dtype
    np.testing.assert_array_equal(packed.float().numpy(), want.astype(np.float32))
    # the bf16 lowering (float matmul of the signs) gives the same integers
    np.testing.assert_array_equal(ops.binary_dense(tx, tw, mode="bf16").float().numpy(),
                                  want.astype(np.float32))


def test_binary_dense_xnor_reaches_b1():
    """mode="xnor" reaches the XNOR-popcount wrapper (its plain version on
    the CPU, no launch) and gives the int8 lowering's integers; an unknown
    mode raises."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((6, 40)).astype(np.float32))
    w = torch.from_numpy(np.random.default_rng(5).uniform(-1, 1, (40, 24)).astype(np.float32))
    before = binary_matmul.launches
    got = ops.binary_dense(x, w, mode="xnor")
    assert binary_matmul.launches == before
    want = ref.int8_matmul_ref(pack_signs_int8(x), pack_signs_int8(w.T))
    np.testing.assert_array_equal(got.numpy(), want.float().numpy())
    with pytest.raises(ValueError, match="unknown binary mode"):
        ops.binary_dense(x, w, mode="xor")


def _qkv(b, s, t, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, hq, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32))


# (causal, G, S, T, kv_len, q_offset): ragged S, per-row kv_len (a row of
# length 1 included), and a query block taken from further down the sequence
FLASH_CASES = [
    (True, 1, 40, 40, None, 0),
    (True, 4, 40, 40, [40, 1], 0),
    (False, 1, 24, 40, [33, 7], 0),
    (False, 4, 40, 40, None, 0),
    (True, 4, 24, 56, [56, 41], 32),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,g,s,t,kv_len,q_offset", FLASH_CASES)
def test_flash_plain_matches_pallas(dtype, causal, g, s, t, kv_len, q_offset):
    hkv, d = 2, 16
    q, k, v = _qkv(2, s, t, hkv * g, hkv, d, seed=s + t + g)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.dtype(dtype)) for a in (q, k, v))
    kvl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, q_offset=q_offset,
                                  kv_len=None if kvl is None else jnp.asarray(kvl),
                                  interpret=True, bq=16, bk=16)
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
                  for a in (jq, jk, jv))
    tkvl = None if kvl is None else torch.from_numpy(kvl)
    got = flash_attention_plain(tq, tk, tv, causal=causal, kv_len=tkvl,
                                q_offset=q_offset, q_block=16, kv_block=16)
    assert got.dtype == tv.dtype and tuple(got.shape) == (2, s, hkv * g, d)
    tol = TOLS[np.float32 if dtype == "float32" else "bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    before = flash_attention.launches
    wrapped = flash_attention(tq, tk, tv, causal=causal, kv_len=tkvl, q_offset=q_offset)
    assert flash_attention.launches == before       # no kernel on the CPU
    np.testing.assert_allclose(wrapped.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
