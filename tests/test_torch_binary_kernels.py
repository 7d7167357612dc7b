"""The port's XNOR-popcount (B1), fused hybrid dense (B5) and bf16 (B6)
plain versions, its trainable xnor op, sign_ste and BatchNorm, against
repro's.

* B1 and B5 are exact (integer dots of +-1 vectors; B5 rounds the product
  and the sum once each in both packages, then takes the sign): equal to
  repro's Pallas kernels in interpret mode on tests/test_kernels.py's
  shapes, and to repro's XLA oracles where the TPU kernel refuses the shape
  (K = 384 packs to 12 words, which bk = 8 does not divide) or has no row
  block that divides M.
* B6 is within tests/test_kernels.py's 2e-2 of bf16_matmul_pallas.
* The xnor op's forward is exact in f32; its STE gradients are within 1e-5
  of jax.grad through repro's op (f32 products summed in another order);
  sign_ste's gradient is equal.
* BatchNorm outputs and running stats are within 1e-6 of repro's (f32
  means and variances summed in another order).
* On a CPU tensor each wrapper runs its plain version and launches nothing.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import accelerator_model as j_am  # noqa: E402
from repro.core import binarize as j_bin  # noqa: E402
from repro.core import hybrid_mlp as j_mlp  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.kernels.bf16_matmul import bf16_matmul_pallas  # noqa: E402
from repro.kernels.binary_matmul import binary_matmul_pallas  # noqa: E402
from repro.kernels.hybrid_dense import hybrid_dense_pallas  # noqa: E402
from repro.nn import layers as j_nn  # noqa: E402
from repro_torch.core import accelerator_model as am  # noqa: E402
from repro_torch.core import hybrid_mlp as H  # noqa: E402
from repro_torch.core.binarize import pack_bits, sign_ste  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain  # noqa: E402
from repro_torch.kernels.binary_matmul import (binary_matmul,  # noqa: E402
                                               binary_matmul_plain)
from repro_torch.kernels.hybrid_dense import hybrid_dense, hybrid_dense_plain  # noqa: E402
from repro_torch.nn import layers as nn  # noqa: E402

torch.set_num_threads(2)

# tests/test_kernels.py THREE_WAY_SHAPES, (M, K, N): K = 100, 250, 40 are
# not multiples of 32
THREE_WAY_SHAPES = [(128, 256, 128), (64, 512, 256), (32, 100, 48),
                    (16, 250, 64), (8, 40, 24)]


def _ab(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((n, k)).astype(np.float32))


def _t(a) -> torch.Tensor:
    """A jax/numpy array as a torch tensor; uint32 words as int32 bits."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("m,k,n", THREE_WAY_SHAPES)
def test_binary_matmul_plain_equals_pallas_and_ref(m, k, n):
    a, w = _ab(m, k, n, seed=7)
    pa, pw = j_bin.pack_bits(jnp.asarray(a)), j_bin.pack_bits(jnp.asarray(w))
    gold = np.asarray(binary_matmul_pallas(pa, pw, k=k, interpret=True))
    np.testing.assert_array_equal(gold, np.asarray(j_ref.binary_matmul_packed_ref(pa, pw, k)))
    got = binary_matmul_plain(pack_bits(torch.from_numpy(a)), _t(pw), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), gold)


@pytest.mark.parametrize("m,k,n", [(64, 384, 64), (77, 160, 130), (1, 1024, 40)])
def test_binary_matmul_wrapper_on_cpu_takes_what_pallas_refuses(m, k, n):
    """Kp = 12 (K = 384), ragged M and N, M = 1: the oracle is repro's XLA
    XNOR twin; the wrapper runs the plain version and launches nothing."""
    a, w = _ab(m, k, n, seed=8)
    pa, pw = j_bin.pack_bits(jnp.asarray(a)), j_bin.pack_bits(jnp.asarray(w))
    before = binary_matmul.launches
    got = binary_matmul(pack_bits(torch.from_numpy(a)), _t(pw), k)
    assert binary_matmul.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_ref.binary_matmul_packed_ref(pa, pw, k)))


def test_binary_matmul_wrapper_rejects_bad_shapes():
    with pytest.raises(ValueError, match="packs to"):
        binary_matmul(torch.zeros(2, 3, dtype=torch.int32),
                      torch.zeros(4, 3, dtype=torch.int32), 32)
    with pytest.raises(TypeError):
        binary_matmul(torch.zeros(2, 1), torch.zeros(4, 1, dtype=torch.int32), 32)


def _scale_shift(n, seed):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(n) * 0.1 + 0.5).astype(np.float32),
            (rng.standard_normal(n) * 0.1).astype(np.float32))


@pytest.mark.parametrize("m,k,n,pallas", [(128, 512, 256, True), (40, 100, 64, False)])
def test_hybrid_dense_plain_bit_exact(m, k, n, pallas):
    """Against hybrid_dense_pallas in interpret mode at a shape it takes,
    and against repro's hybrid_dense_ref at ragged K."""
    a, w = _ab(m, k, n, seed=2)
    scale, shift = _scale_shift(n, seed=5)
    pa, pw = j_bin.pack_bits(jnp.asarray(a)), j_bin.pack_bits(jnp.asarray(w))
    js, jh = jnp.asarray(scale), jnp.asarray(shift)
    want = (hybrid_dense_pallas(pa, pw, js, jh, k=k, interpret=True) if pallas
            else j_ref.hybrid_dense_ref(pa, pw, js, jh, k))
    args = (pack_bits(torch.from_numpy(a)), _t(pw), torch.from_numpy(scale),
            torch.from_numpy(shift), k)
    got = hybrid_dense_plain(*args)
    assert got.dtype == torch.int32 and got.shape == (m, n // 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
    before = hybrid_dense.launches
    np.testing.assert_array_equal(hybrid_dense(*args).numpy(), got.numpy())
    assert hybrid_dense.launches == before


def test_hybrid_dense_refuses_ragged_n():
    one = torch.ones(40)
    with pytest.raises(ValueError, match="N % 32"):
        hybrid_dense(torch.zeros(4, 2, dtype=torch.int32),
                     torch.zeros(40, 2, dtype=torch.int32), one, one, 64)


@pytest.mark.parametrize("hardtanh", [False, True])
@pytest.mark.parametrize("m,k,n", [(128, 256, 128), (64, 512, 256)])
def test_bf16_matmul_plain_matches_pallas(m, k, n, hardtanh):
    a, w = _ab(m, k, n, seed=4)
    ja, jw = jnp.asarray(a, jnp.bfloat16), jnp.asarray(w.T, jnp.bfloat16)
    want = np.asarray(bf16_matmul_pallas(ja, jw, hardtanh=hardtanh, interpret=True))
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(torch.bfloat16)
    got = bf16_matmul_plain(ta, tw, hardtanh=hardtanh)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)
    before = bf16_matmul.launches
    np.testing.assert_array_equal(bf16_matmul(ta, tw, hardtanh=hardtanh).numpy(), got.numpy())
    assert bf16_matmul.launches == before


def test_bf16_matmul_takes_what_pallas_refuses():
    """fc0's K = 784 (the TPU kernel asserts k % min(512, K) == 0) and fc3's
    N = 10, against repro's bf16_matmul_ref."""
    a, w = _ab(32, 784, 10, seed=6)
    want = np.asarray(j_ref.bf16_matmul_ref(jnp.asarray(a), jnp.asarray(w.T)))
    got = bf16_matmul(torch.from_numpy(a).to(torch.bfloat16),
                      torch.from_numpy(np.ascontiguousarray(w.T)).to(torch.bfloat16))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("k", [64, 100])
def test_xnor_op_forward_and_ste_grads_match_repro(k):
    rng = np.random.default_rng(k)
    x = rng.uniform(-1.5, 1.5, (2, 5, k)).astype(np.float32)     # |x| > 1 masked
    w = rng.uniform(-1.2, 1.2, (k, 48)).astype(np.float32)
    g = rng.standard_normal((2, 5, 48)).astype(np.float32)

    def j_loss(x, w):
        return jnp.sum(j_ops.binary_dense(x, w, mode="xnor") * g)

    want_y = np.asarray(j_ops.binary_dense(jnp.asarray(x), jnp.asarray(w), mode="xnor"))
    want_gx, want_gw = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = ops.binary_dense(tx, tw, mode="xnor")
    np.testing.assert_array_equal(y.detach().numpy(), want_y)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_gw), rtol=1e-5, atol=1e-5)
    # the packed inference path gives the same integers
    np.testing.assert_array_equal(
        ops.binary_dense_packed(torch.from_numpy(x), pack_bits(torch.from_numpy(w).T)).numpy(),
        want_y)


def test_sign_ste_matches_repro():
    x = np.array([-2.0, -1.0, -0.5, 0.0, 0.5, 1.0, 1.0001, 3.0], np.float32)
    g = np.arange(1, 9, dtype=np.float32)
    want_y, vjp = jax.vjp(j_bin.sign_ste, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    y = sign_ste(tx)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want_y))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_matches_repro(training):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((48, 64)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 64), "bias": rng.standard_normal(64),
         "mean": rng.standard_normal(64), "var": rng.uniform(0.5, 2.0, 64)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want_y, want_new = j_nn.batchnorm_apply({k: jnp.asarray(v) for k, v in p.items()},
                                            jnp.asarray(x), training=training)
    got_y, got_new = nn.batchnorm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                        torch.from_numpy(x), training=training)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=1e-6, atol=1e-6)
    for k in p:
        np.testing.assert_allclose(got_new[k].numpy(), np.asarray(want_new[k]),
                                   rtol=1e-6, atol=1e-6)


def test_tables_match_repro():
    """Table II to the byte, and the FPGA model's Tables I-III equal to
    repro's (the same pure-Python arithmetic)."""
    assert H.weight_memory_bytes(hybrid=True) == j_mlp.weight_memory_bytes(hybrid=True) \
        == 1_888_256
    assert H.weight_memory_bytes(hybrid=False) == j_mlp.weight_memory_bytes(hybrid=False) \
        == 5_820_416
    m, jm = am.fit(), j_am.fit()
    assert (m.o_float, m.o_binary) == (jm.o_float, jm.o_binary)
    assert am.table1(m) == j_am.table1(jm)
    assert am.table2() == j_am.table2()
    assert am.table3(m) == j_am.table3(jm)


def test_binarize_oracles_match_repro():
    """binary_dot_packed (leading batch axes, K = 70 with pad bits) and the
    float oracle binary_matmul_ref equal repro's."""
    from repro_torch.core.binarize import binary_dot_packed, binary_matmul_ref
    rng = np.random.default_rng(9)
    a = rng.standard_normal((2, 3, 70)).astype(np.float32)
    w = rng.standard_normal((5, 70)).astype(np.float32)
    pa, pw = j_bin.pack_bits(jnp.asarray(a)), j_bin.pack_bits(jnp.asarray(w))
    np.testing.assert_array_equal(binary_dot_packed(_t(pa), _t(pw), 70).numpy(),
                                  np.asarray(j_bin.binary_dot_packed(pa, pw, 70)))
    np.testing.assert_array_equal(
        binary_matmul_ref(torch.from_numpy(a[0]), torch.from_numpy(w)).numpy(),
        np.asarray(j_bin.binary_matmul_ref(jnp.asarray(a[0]), jnp.asarray(w))))
