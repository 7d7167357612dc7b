"""The port's bit format against repro's: pack_bits, unpack_bits and
pack_signs_int8 are bit-identical (repro's uint32 words read as the port's
int32 words), on the shapes of tests/test_pack_property.py — K values that
straddle the 32-bit lane included — and on its degenerate sign patterns.
No tolerance: the format is exact."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import binarize as jb  # noqa: E402
from repro_torch.core import binarize as tb  # noqa: E402

torch.set_num_threads(2)

# (rows, K, mode): K = 1, 31, 32, 33, 63, 64, 65, 100 as in the property
# tests' K range, with their all-plus / all-minus / zeros columns
CASES = [(r, k, m) for (r, k) in [(1, 1), (3, 31), (8, 32), (2, 33), (5, 63),
                                  (4, 64), (7, 65), (6, 100)]
         for m in ("random", "all_plus", "all_minus", "zeros")]


def _signs(rows, k, seed, mode):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, k)).astype(np.float32)
    if mode == "all_plus":
        x = np.abs(x)
    elif mode == "all_minus":
        x = -np.abs(x) - 1e-3
    elif mode == "zeros":
        x[:, ::2] = 0.0            # sign(0) is +1 in both packages
    return x


@pytest.mark.parametrize("rows,k,mode", CASES)
def test_pack_unpack_bit_identical(rows, k, mode):
    x = _signs(rows, k, rows * 1000 + k, mode)
    want = np.asarray(jb.pack_bits(jnp.asarray(x))).view(np.int32)
    got = tb.pack_bits(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and got.shape == (rows, tb.packed_len(k))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tb.unpack_bits(torch.from_numpy(got), k).numpy(),
        np.asarray(jb.unpack_bits(jnp.asarray(want.view(np.uint32)), k)))
    np.testing.assert_array_equal(
        tb.pack_signs_int8(torch.from_numpy(x)).numpy(),
        np.asarray(jb.pack_signs_int8(jnp.asarray(x))))


def test_pad_bits_are_one_and_sign_of_zero_is_plus():
    x = torch.zeros(2, 33)
    words = tb.pack_bits(x)
    assert (words == -1).all()     # 32 + 1 sign bits and 31 pad bits, all 1
    assert (tb.pack_signs_int8(x) == 1).all()


def test_pack_bits_batched_leading_axes():
    x = _signs(12, 70, 5, "random").reshape(3, 4, 70)
    np.testing.assert_array_equal(
        tb.pack_bits(torch.from_numpy(x)).numpy(),
        np.asarray(jb.pack_bits(jnp.asarray(x))).view(np.int32))
