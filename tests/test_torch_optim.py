"""The port's optimizer (repro_torch/optim) against repro's, on the cases of
tests/test_optim.py: every function's output within 1e-6 of repro's on the
same inputs (both compute in f32, rounding the same formula)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as J  # noqa: E402
from repro_torch import optim as T  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-6


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else \
        x.detach().to(torch.float32).numpy()


def test_adamw_minimizes_quadratic_as_repro():
    w0 = np.array([3.0, -2.0, 1.0], np.float32)
    jp, tp = {"w": jnp.asarray(w0)}, {"w": torch.from_numpy(w0.copy())}
    jo, to = J.adamw_init(jp), T.adamw_init(tp)
    for _ in range(200):
        jg = jax.grad(lambda p: jnp.sum(p["w"] ** 2))(jp)
        jp, jo = J.adamw_update(jp, jg, jo, lr=0.05, weight_decay=0.0)
        tp, to = T.adamw_update(tp, {"w": 2 * tp["w"]}, to, lr=0.05, weight_decay=0.0)
        np.testing.assert_allclose(_np(tp["w"]), _np(jp["w"]), rtol=0, atol=TOL)
    assert float(tp["w"].abs().max()) < 0.05
    assert int(to["step"]) == 200 == int(jo["step"])
    for k in ("m", "v"):
        np.testing.assert_allclose(_np(to[k]["w"]), _np(jo[k]["w"]), rtol=0, atol=TOL)


@pytest.mark.parametrize("step", [0, 5, 10, 11, 50, 99, 120])
def test_cosine_schedule_equals_repro(step):
    kw = dict(peak_lr=1.0, warmup=10, total=100)
    got = float(T.cosine_schedule(step, **kw))
    assert got == pytest.approx(float(J.cosine_schedule(step, **kw)), abs=TOL)
    got_t = float(T.cosine_schedule(torch.tensor(step, dtype=torch.int32), **kw))
    assert got_t == got
    if step == 0:
        assert got < 0.2
    if step == 10:
        assert abs(got - 1.0) < 0.1
    if step == 99:
        assert 0.1 * 0.99 <= got < 0.2          # the floor


def test_clip_by_global_norm_equals_repro():
    rng = np.random.default_rng(0)
    g = {"a": np.full((4,), 10.0, np.float32), "b": [rng.normal(size=(3, 5)).astype(np.float32)]}
    jc, jgn = J.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tgn = T.clip_by_global_norm({"a": torch.from_numpy(g["a"]),
                                     "b": [torch.from_numpy(g["b"][0])]}, 1.0)
    assert float(tgn) == pytest.approx(float(jgn), rel=TOL)
    assert abs(float(tgn) - float(np.sqrt(400 + (g["b"][0] ** 2).sum()))) < 1e-4
    np.testing.assert_allclose(_np(tc["a"]), _np(jc["a"]), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(tc["b"][0]), _np(jc["b"][0]), rtol=0, atol=TOL)
    norm = float(torch.sqrt(sum((t ** 2).sum() for t in (tc["a"], tc["b"][0]))))
    assert norm == pytest.approx(1.0, rel=1e-4)


def test_clip_latent_weights_equals_repro():
    w = np.array([2.0, -3.0, 0.5], np.float32)
    jout = J.clip_latent_weights({"ffn": {"bin_in": {"w_latent": jnp.asarray(w)}},
                                  "other": {"w": jnp.array([5.0])}})
    params = {"blocks": [{"ffn": {"bin_in": {"w_latent": torch.from_numpy(w)}}}],
              "other": {"w": torch.tensor([5.0])}}
    out = T.clip_latent_weights(params)
    np.testing.assert_array_equal(out["blocks"][0]["ffn"]["bin_in"]["w_latent"].numpy(),
                                  np.asarray(jout["ffn"]["bin_in"]["w_latent"]))
    np.testing.assert_array_equal(out["blocks"][0]["ffn"]["bin_in"]["w_latent"].numpy(),
                                  [1.0, -1.0, 0.5])
    assert out["other"]["w"] is params["other"]["w"]              # untouched, shared
    assert params["blocks"][0]["ffn"]["bin_in"]["w_latent"][1] == -3.0   # no in-place


def test_bf16_moments_equal_repro():
    jp = {"w": jnp.zeros((8,), jnp.bfloat16)}
    jo = J.adamw_init(jp, moment_dtype=jnp.bfloat16)
    jp2, jo2 = J.adamw_update(jp, {"w": jnp.ones((8,), jnp.bfloat16)}, jo, lr=0.1)
    tp = {"w": torch.zeros((8,), dtype=torch.bfloat16)}
    to = T.adamw_init(tp, moment_dtype=torch.bfloat16)
    assert to["m"]["w"].dtype == torch.bfloat16
    tp2, to2 = T.adamw_update(tp, {"w": torch.ones((8,), dtype=torch.bfloat16)}, to, lr=0.1)
    assert to2["v"]["w"].dtype == torch.bfloat16 and tp2["w"].dtype == torch.bfloat16
    assert torch.isfinite(tp2["w"].float()).all()
    for got, want in ((tp2["w"], jp2["w"]), (to2["m"]["w"], jo2["m"]["w"]),
                      (to2["v"]["w"], jo2["v"]["w"])):
        np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=TOL)


def test_adamw_with_weight_decay_leaves_inputs_unchanged():
    """Functional, as repro's: the step returns new tensors and changes none
    it was given (a retried step must start from the same params)."""
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    g0 = {"w": rng.normal(size=(4, 3)).astype(np.float32)}
    tp = {"w": torch.from_numpy(p0["w"].copy())}
    to = T.adamw_init(tp)
    tp2, to2 = T.adamw_update(tp, {"w": torch.from_numpy(g0["w"])}, to, lr=0.01)
    jp2, _ = J.adamw_update({"w": jnp.asarray(p0["w"])}, {"w": jnp.asarray(g0["w"])},
                            J.adamw_init({"w": jnp.asarray(p0["w"])}), lr=0.01)
    np.testing.assert_allclose(_np(tp2["w"]), _np(jp2["w"]), rtol=0, atol=TOL)
    np.testing.assert_array_equal(tp["w"].numpy(), p0["w"])
    assert int(to["step"]) == 0 and not to["m"]["w"].any()
