"""The paper's hybrid MNIST net in the port against repro's, at full width
(784-1024-1024-1024-10), on params made by repro's ``mlp_init`` and
carried over by ``mlp_params_from_jax``.

Both run f32. The float layers' products sum in another order, so values
differ by ~1e-6 before the binary layers take their signs; the inputs
(seed 7) are chosen so that no such value lies within 1e-5 of 0, which
each test asserts, and then logits, the loss and the gradients agree within
1e-4. The binary layers' own outputs are exact integers, and in training
mode their batch mean is exact too (a power-of-two batch), so a value that
BatchNorm sends to exactly 0 does so in both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import hybrid_mlp as J  # noqa: E402
from repro.core.binarize import hardtanh as j_hardtanh  # noqa: E402
from repro.core.binary_dense import binary_dense_apply as j_bd_apply  # noqa: E402
from repro.data.synthetic import SyntheticMnist as JSyntheticMnist  # noqa: E402
from repro.nn import layers as j_nn  # noqa: E402
from repro_torch.core import hybrid_mlp as H  # noqa: E402
from repro_torch.data.synthetic import SyntheticMnist  # noqa: E402
from repro_torch.examples import quickstart as Q  # noqa: E402
from repro_torch.models.convert import mlp_params_from_jax  # noqa: E402

torch.set_num_threads(2)

BATCH, SEED = 32, 7
MARGIN = 1e-5


@pytest.fixture(scope="module")
def j_params():
    return {h: J.mlp_init(jax.random.PRNGKey(0), hybrid=h) for h in (False, True)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(j_tree):
    return mlp_params_from_jax(_np(j_tree), device="cpu")


def _batch():
    rng = np.random.default_rng(SEED)
    return (rng.uniform(-1, 1, (BATCH, 784)).astype(np.float32),
            rng.integers(0, 10, BATCH).astype(np.int32))


def _sign_margin(params, x, training) -> float:
    """Smallest |value| that a float layer's output hands to a binary
    layer's sign, through repro's own layers."""
    h, out = jnp.asarray(x), []
    for i in range(3):
        p = params[f"fc{i}"]
        h = j_bd_apply(p["bin"], h) if "bin" in p else \
            j_nn.dense_apply(p, h, compute_dtype=jnp.float32)
        h, _ = j_nn.batchnorm_apply(params[f"bn{i}"], h, training=training)
        h = j_hardtanh(h)
        if "bin" not in p and "bin" in params[f"fc{i + 1}"]:
            out.append(float(jnp.abs(h).min()))
    return min(out, default=np.inf)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_mlp_apply_matches_repro(j_params, hybrid, training):
    jp = j_params[hybrid]
    x, _ = _batch()
    assert _sign_margin(jp, x, training) > MARGIN
    want, want_new = J.mlp_apply(jp, jnp.asarray(x), training=training)
    got, got_new = H.mlp_apply(_port(jp), torch.from_numpy(x), training=training)
    assert got.shape == (BATCH, 10)
    _close(got, want)
    for i in range(3):
        for stat in ("mean", "var"):
            _close(got_new[f"bn{i}"][stat], want_new[f"bn{i}"][stat])


def test_sgd_step_matches_repro(j_params):
    """One step of the quickstart's SGD: the loss, every gradient, and the
    updated params (latents clipped, BN stats copied) within 1e-4."""
    jp = j_params[True]
    x, y = _batch()
    assert _sign_margin(jp, x, True) > MARGIN
    (want_loss, (want_new, _)), want_g = jax.value_and_grad(J.mlp_loss, has_aux=True)(
        jp, (jnp.asarray(x), jnp.asarray(y)))
    tp = _port(jp)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    loss, grads, _ = Q.loss_and_grads(tp, tx, ty)
    _close(loss, want_loss)
    assert len(grads) == 12        # w, b of fc0 and fc3, two latents, 3 BN scales, biases
    for path, g in grads.items():
        want = want_g
        for k in path:
            want = want[k]
        _close(g, want)

    upd, _ = Q.train_step(tp, tx, ty)
    want_upd = jax.tree.map(lambda p, g: p - Q.LR * g, jp, want_g)
    for k in ("fc1", "fc2"):
        want_upd[k]["bin"]["w_latent"] = jnp.clip(want_upd[k]["bin"]["w_latent"], -1, 1)
    for k in want_new:
        if k.startswith("bn"):
            want_upd[k] = {**want_upd[k], "mean": want_new[k]["mean"],
                           "var": want_new[k]["var"]}
    for path, t in Q._leaves(upd):
        want = want_upd
        for k in path:
            want = want[k]
        _close(t, want)


def test_pack_and_packed_inference_match_repro(j_params):
    jp = j_params[True]
    x, _ = _batch()
    assert _sign_margin(jp, x, False) > MARGIN
    j_packed = J.mlp_pack(jp)
    packed = H.mlp_pack(_port(jp))
    for k in ("fc1", "fc2"):
        np.testing.assert_array_equal(
            packed[k]["bin_packed"]["w_packed"].numpy(),
            np.asarray(j_packed[k]["bin_packed"]["w_packed"]).view(np.int32))
    want = J.mlp_apply_packed(j_packed, jnp.asarray(x))
    got = H.mlp_apply_packed(packed, torch.from_numpy(x))
    _close(got, want)
    # repro's packed params convert too (uint32 words -> int32 bits)
    _close(H.mlp_apply_packed(_port(j_packed), torch.from_numpy(x)), want)
    # eval with latents runs the same integer dots
    _close(H.mlp_apply(_port(jp), torch.from_numpy(x), training=False)[0], got, rtol=0)


def test_synthetic_mnist_is_repro_s():
    mine, ref = SyntheticMnist(n_train=64, n_test=32), JSyntheticMnist(n_train=64, n_test=32)
    for a, b in zip((*mine.train, *mine.test), (*ref.train, *ref.test)):
        np.testing.assert_array_equal(a, b)
    for (xa, ya), (xb, yb) in zip(mine.batches("train", 16, seed=3),
                                  ref.batches("train", 16, seed=3)):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_quickstart_training_beats_chance_on_cpu():
    """The port's own training loop (2 epochs, SGD lr 0.05, batch 128) on the
    CPU clears test_core_mlp.py's bar for the hybrid net: > 0.6 (0.90 on
    these 1,024 training images, 0.97 on 2,048)."""
    data = SyntheticMnist(n_train=1024, n_test=512, seed=0)
    params = H.mlp_init(0, hybrid=True, device="cpu")
    params, accs = Q.train(params, data)
    assert accs[-1] > 0.6, accs
    for k in ("fc1", "fc2"):
        assert float(params[k]["bin"]["w_latent"].abs().max()) <= 1.0
