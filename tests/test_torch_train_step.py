"""The port's LM loss, gradients and train step against repro's.

``smoke_config("stablelm-3b")`` in f32 (3 blocks, the middle one a binary
FFN), in int8 and in xnor mode, on repro's params carried over latent-only
(``params_from_jax(..., packed=False)``), one SyntheticTokens batch:

  * the loss and its metrics within 1e-5 of ``api.loss``;
  * every gradient leaf within 1e-4 of repro's ``jax.grad``, relative to
    the leaf's largest magnitude (the STE's f32 products and attention sum
    in other orders; every sign before the binary FFN agrees, as in
    tests/test_torch_models.py);
  * remat "block" gives the grads of remat "none" (the recompute is the
    same forward), and "dots" is refused;
  * three train steps (clip, cosine schedule, AdamW, the latent clip)
    give params within 1e-5 of repro's; with grad_accum=2 the accumulated
    grads match repro's and so do one step's params;
  * B3's autograd Function (on the CPU its forward is the plain version,
    its backward autograd through the plain version, as on the card)
    gives the q, k and v grads of jax.vjp through flash_attention_pallas
    (interpret mode) within 1e-5, with kv_len, q_offset and GQA;
  * the loss falls over 60 steps (tests/test_system.py's bar), and the
    trained params, packed for serving, give the logits of the training
    forward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.train.step import make_train_step as j_make_train_step  # noqa: E402
from repro_torch.configs import PrecisionPolicy, smoke_config  # noqa: E402
from repro_torch.core.binary_dense import pack_tree  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import get_model, lm_common as lc  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train.step import (accumulated_loss_and_grads, loss_and_grads,  # noqa: E402
                                    make_train_step)
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

torch.set_num_threads(2)

F32 = dict(compute_dtype="float32", param_dtype="float32")
# at peak lr 1e-3: AdamW moves an element whose gradient is near eps (1e-8)
# by lr x g / (|g| + eps), so the grads' ~1e-6 relative rounding
# differences there become up to 4e-3 x lr in the params (4.0e-6 here)
STEP_KW = dict(peak_lr=1e-3, warmup=1, total=10)


def _cfgs(mode):
    pol = dict(binary_ffn=True, edge_blocks_float=1, binary_mode=mode)
    jcfg = j_smoke("stablelm-3b").replace(**F32)
    cfg = smoke_config("stablelm-3b").replace(**F32, policy=PrecisionPolicy(**pol))
    return jcfg.replace(policy=jcfg.policy.__class__(**pol)), cfg


def _batch(cfg, seed=0, batch=2, seq=16):
    return next(SyntheticTokens(cfg.vocab, seq, batch, seed=seed))


def _port(tree, cfg):
    """repro's params-shaped tree (params, grads, moments) -> the port's."""
    return params_from_jax(jax.tree.map(np.asarray, tree), cfg, device="cpu", packed=False)


def _close(got, want, tol, rel=False):
    """Every leaf of the port's tree within tol of repro's (relative to the
    leaf's max-abs where rel)."""
    want = dict(tree_leaves_with_path(want))
    for path, g in tree_leaves_with_path(got):
        w = want.pop(path)
        err = float((g - w).abs().max())
        scale = float(w.abs().max()) if rel else 1.0
        assert err <= tol * max(scale, 1e-30), (path, err, scale)
    assert not want, sorted(want)


@pytest.fixture(scope="module", params=["int8", "xnor"])
def pair(request):
    jcfg, cfg = _cfgs(request.param)
    japi = j_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    return (jcfg, japi, jparams), (cfg, get_model(cfg), _port(jparams, cfg))


@pytest.fixture(scope="module")
def grads(pair):
    (jcfg, japi, jparams), (cfg, api, params) = pair
    b = _batch(cfg)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, b))
    loss, m, g = loss_and_grads(api, params, {k: torch.from_numpy(v) for k, v in b.items()})
    return (jloss, jm, jg), (loss, m, g)


def test_loss_matches_repro(pair, grads):
    (jloss, jm, _), (loss, m, _) = grads
    assert set(m) == set(jm) == {"ce", "aux", "loss"}
    assert abs(float(loss) - float(jloss)) <= 1e-5
    for k in m:
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5, k
    (_, _, _), (cfg, api, params) = pair
    b = _batch(cfg)
    eval_loss, _ = api.loss(params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert float(eval_loss) == float(loss)


def test_grads_match_repro(pair, grads):
    (_, _, jg), (_, _, g) = grads
    cfg = pair[1][0]
    _close(g, _port(jg, cfg), 1e-4, rel=True)
    # the attention weights of every block get a gradient through B3's
    # Function, and each binary latent through the STE
    for blk in g["blocks"]:
        for name in ("wq", "wk", "wv", "wo"):
            assert blk["attn"][name]["w"].abs().max() > 0, name
    assert g["blocks"][1]["ffn"]["bin_in"]["w_latent"].abs().max() > 0


def test_remat_block_equals_none_and_dots_is_refused(pair):
    (_, _, _), (cfg, _, params) = pair
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    out = {}
    for remat in ("none", "block"):
        out[remat] = loss_and_grads(get_model(cfg.replace(remat=remat)), params, b)
    assert float(out["none"][0]) == float(out["block"][0])
    for (_, a), (_, c) in zip(tree_leaves_with_path(out["none"][2]),
                              tree_leaves_with_path(out["block"][2])):
        assert torch.equal(a, c)
    with pytest.raises(NotImplementedError, match="dots"):
        loss_and_grads(get_model(cfg.replace(remat="dots")), params, b)


def test_three_train_steps_match_repro(pair):
    (jcfg, japi, jparams), (cfg, api, params) = pair
    jstep = jax.jit(j_make_train_step(japi, jcfg, **STEP_KW))
    step = make_train_step(api, cfg, **STEP_KW)
    jopt, opt = j_adamw_init(jparams), adamw_init(params)
    data = SyntheticTokens(cfg.vocab, 16, 2, seed=1)
    for _ in range(3):
        b = next(data)
        jparams, jopt, jm = jstep(jparams, jopt, jax.tree.map(jnp.asarray, b))
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * max(1.0, abs(float(jm[k]))), k
    assert int(opt["step"]) == int(jopt["step"]) == 3
    _close(params, _port(jparams, cfg), 1e-5)
    _close(opt["m"], _port(jopt["m"], cfg), 1e-5)
    for blk in params["blocks"]:
        if "bin_in" in blk["ffn"]:
            assert float(blk["ffn"]["bin_in"]["w_latent"].abs().max()) <= 1.0


def test_grad_accum_matches_repro():
    """The accumulated gradients (two microbatches' f32 grads summed and
    halved) within 1e-4 of repro's, relative to each leaf's max-abs; then
    one step's params within 1e-5 at peak lr 1e-4. An AdamW step moves an
    element by lr x g / (|g| + eps): where the two microbatches' grads
    cancel to ~eps, their ~1e-6 relative rounding differences become ~2% of
    a step (2e-5 at lr 1e-3), so the params' tolerance is in units of lr."""
    jcfg, cfg = _cfgs("int8")
    japi, api = j_get_model(jcfg), get_model(cfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    params = _port(jparams, cfg)
    b = {k: v.reshape(2, 2, -1) for k, v in _batch(cfg, batch=4).items()}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jgrad = jax.jit(jax.grad(lambda p, mb: japi.loss(p, mb)[0]))
    jg = [jgrad(jparams, jax.tree.map(lambda v, i=i: jnp.asarray(v[i]), b)) for i in range(2)]
    _, _, g = accumulated_loss_and_grads(api, params, tb, grad_accum=2)
    _close(g, _port(jax.tree.map(lambda x, y: (x + y) / 2, *jg), cfg), 1e-4, rel=True)
    kw = {**STEP_KW, "peak_lr": 1e-4}
    jp, _, jm = jax.jit(j_make_train_step(japi, jcfg, grad_accum=2, **kw))(
        jparams, j_adamw_init(jparams), jax.tree.map(jnp.asarray, b))
    p, _, m = make_train_step(api, cfg, grad_accum=2, **kw)(params, adamw_init(params), tb)
    assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-5
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5 * float(jm["grad_norm"])
    _close(p, _port(jp, cfg), 1e-5)


def test_train_step_refuses_a_packed_copy():
    """The serving copy of the sign words would go stale at the first
    update: the trainer takes latent-only params."""
    cfg = _cfgs("int8")[1]
    api = get_model(cfg)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="latent-only"):
        loss_and_grads(api, api.init(0, device="cpu"), b)


# (B, S, T, Hq, Hkv, D, causal, kv_len, q_offset)
FLASH_CASES = [
    (2, 16, 16, 4, 4, 16, True, None, 0),
    (2, 16, 16, 4, 4, 16, True, [16, 5], 0),
    (2, 8, 24, 4, 4, 16, True, [24, 19], 16),
    (2, 16, 16, 8, 2, 16, True, [16, 9], 0),
    (2, 12, 20, 4, 2, 16, False, [20, 7], 0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: f"B{c[0]}S{c[1]}T{c[2]}G{c[3]//c[4]}"
                         f"{'c' if c[6] else 'n'}{'' if c[7] is None else 'L'}o{c[8]}")
def test_flash_function_grads_match_repro(case):
    b, s, t, hq, hkv, d, causal, kv_len, q_offset = case
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shape).astype(np.float32)
               for shape in ((b, s, hq, d), (b, t, hkv, d), (b, t, hkv, d)))
    g = rng.normal(size=(b, s, hq, d)).astype(np.float32)
    kvl = None if kv_len is None else np.array(kv_len, np.int32)
    out, pull = jax.vjp(lambda q, k, v: flash_attention_pallas(
        q, k, v, causal=causal, kv_len=None if kvl is None else jnp.asarray(kvl),
        q_offset=q_offset, interpret=True), jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = pull(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset,
                          kv_len=None if kvl is None else torch.from_numpy(kvl))
    assert got.grad_fn is not None
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=1e-5)
    got.backward(torch.from_numpy(g))
    for name, tg, wg in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(tg.numpy(), np.asarray(wg), rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.fixture(scope="module")
def trained():
    """The hybrid smoke LM (its middle block binary), f32, 60 steps as
    tests/test_system.py trains its LM."""
    cfg = _cfgs("int8")[1].replace(remat="none")
    api = get_model(cfg)
    params = api.init(0, device="cpu", packed=False)
    opt = adamw_init(params)
    step = make_train_step(api, cfg, peak_lr=3e-3, warmup=5, total=60)
    data = SyntheticTokens(cfg.vocab, 32, 8, seed=0, noise=0.02)
    losses = []
    for _ in range(60):
        params, opt, m = step(params, opt, {k: torch.from_numpy(v) for k, v in next(data).items()})
        losses.append(float(m["loss"]))
    return cfg, api, params, losses


def test_loss_falls_over_60_steps(trained):
    losses = trained[3]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first * 0.7, (first, last)


def test_trained_params_packed_serve_the_training_logits(trained):
    cfg, api, params, _ = trained
    toks = torch.from_numpy(_batch(cfg, seed=5, batch=3, seq=12)["tokens"])
    with torch.no_grad():
        x = tr._embed(params, cfg, toks)
        h, _ = lc.segments_apply(params["blocks"], x, cfg,
                                 positions=torch.arange(toks.shape[1]))
        want = tr._logits(params, cfg, h)[:, -1]
        got, _ = api.prefill(pack_tree(params), {"tokens": toks})
    assert "w_packed" in pack_tree(params)["blocks"][1]["ffn"]["bin_in"]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
