"""The port's MoE layer (models/moe.py), its batched binary products
(kernels/ops.py) and the MoE branches of deploy, convert and the latent clip,
against repro, at ``smoke_config("deepseek-v2-236b")`` (8 experts, top-2, 1
shared expert) in f32, on repro's params:

  * tests/test_moe.py's cells: both routers' gates normalized (and equal to
    repro's, with its expert picks and aux loss), uncapped dispatch equal to
    the dense per-token mixture and to repro's moe_apply, a heavy capacity
    drop equal to repro's (the stable sort drops the same pairs), binary
    experts equal to repro's for int8 and xnor, latent and deployed;
  * binary_dense_batched: the exact integers of repro's, and its STE grads;
  * deploy and convert round trips of a whole MoE model, and the binary MoE
    latent clip.

Tolerances: 1e-5 where only float sums are reordered; exact for the +-1
products. The binary cells hold 1e-5 because the same signs go in on both
sides (no input sits within ~1e-6 of 0).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models.deploy import deploy_params as j_deploy  # noqa: E402
from repro.optim.bnn import clip_latent_weights as j_clip  # noqa: E402
from repro_torch.configs import PrecisionPolicy, smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.deploy import deploy_params  # noqa: E402
from repro_torch.optim.bnn import clip_latent_weights  # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
F32 = dict(compute_dtype="float32", param_dtype="float32")


def _cfgs(**kw):
    return (j_smoke("deepseek-v2-236b").replace(**F32, **kw),
            smoke_config("deepseek-v2-236b").replace(**F32, **kw))


def _tensor(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _port(tree):
    """repro's arrays -> tensors (packed uint32 words as the port's int32)."""
    return tree_map(_tensor, jax.tree.map(np.asarray, tree))


def _layer(cfgs, binary, seed=0):
    jcfg, cfg = cfgs
    jp = j_moe.moe_init(jax.random.PRNGKey(seed), jcfg, binary=binary)
    return jp, _port(jp)


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_router_gates_normalized_and_equal_repro(router):
    cfgs = _cfgs(router_type=router)
    jp, p = _layer(cfgs, binary=False)
    x = _x((8, cfgs[1].d_model), 1)
    jg, jidx, jaux = j_moe._route(jp, jnp.asarray(x), cfgs[0])
    g, idx, aux = moe._route(p, torch.from_numpy(x), cfgs[1])
    np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, rtol=1e-4)
    assert idx.shape == (8, cfgs[1].top_k) and int(idx.max()) < cfgs[1].n_experts
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(g, jg)
    _close(aux, jaux)
    if router == "sigmoid":
        assert "bias" in p["router"] and float(aux) == 0.0


def test_uncapped_dispatch_equals_dense_mixture_and_repro():
    cfgs = _cfgs(capacity_factor=64.0, n_shared_experts=0)
    cfg = cfgs[1]
    jp, p = _layer(cfgs, binary=False)
    x = _x((2, 8, cfg.d_model), 2, 0.5)
    y, aux = moe.moe_apply(p, torch.from_numpy(x), cfg)
    jy, jaux = jax.jit(j_moe.moe_apply, static_argnums=2)(jp, jnp.asarray(x), cfgs[0])
    _close(y, jy)
    _close(aux, jaux)
    # the dense reference: every token through its top-k experts
    x2 = torch.from_numpy(x).reshape(-1, cfg.d_model)
    gates, idx, _ = moe._route(p, x2, cfg)
    want = torch.zeros_like(x2)
    for t in range(x2.shape[0]):
        for j in range(cfg.top_k):
            e = int(idx[t, j])
            sub = {k: p[k][e:e + 1] for k in ("w_gate", "w_up", "w_down")}
            want[t] += gates[t, j] * moe._expert_ffn(sub, x2[t][None, None], cfg)[0, 0]
    _close(y.reshape(-1, cfg.d_model), want.numpy())


def test_capacity_drop_equals_repro():
    cfgs = _cfgs(capacity_factor=0.01)            # capacity 8 of 64 pairs an expert
    jp, p = _layer(cfgs, binary=False)
    x = _x((2, 32, cfgs[1].d_model), 3)
    y, _ = moe.moe_apply(p, torch.from_numpy(x), cfgs[1])
    jy, _ = jax.jit(j_moe.moe_apply, static_argnums=2)(jp, jnp.asarray(x), cfgs[0])
    assert bool(torch.isfinite(y).all())
    _close(y, jy)
    # tokens whose every pair was dropped get the shared expert's output alone
    shared = moe.nn.swiglu_apply(p["shared"], torch.from_numpy(x).reshape(64, -1),
                                 compute_dtype=torch.float32)
    dropped = (y.reshape(64, -1) - shared).abs().amax(-1) == 0
    assert 0 < int(dropped.sum()) < 64


@pytest.mark.parametrize("mode", ["int8", "xnor"])
def test_binary_experts_equal_repro_latent_and_deployed(mode):
    pol = dict(binary_ffn=True, edge_blocks_float=1, binary_mode=mode)
    jcfg, cfg = _cfgs()
    jcfg = jcfg.replace(policy=jcfg.policy.__class__(**pol))
    cfg = cfg.replace(policy=PrecisionPolicy(**pol))
    jp, p = _layer((jcfg, cfg), binary=True)
    assert "s_mid" in p and float(p["w_gate"].abs().max()) <= 1.0
    x = _x((2, 8, cfg.d_model), 4)
    apply = jax.jit(j_moe.moe_apply, static_argnums=2)
    jy, _ = apply(jp, jnp.asarray(x), jcfg)
    y, _ = moe.moe_apply(p, torch.from_numpy(x), cfg)
    _close(y, jy)
    # deployed: the *_q stacks of both packages' deploy, the same bits
    jd = j_deploy({"ffn": jp}, jcfg)["ffn"]
    d = deploy_params({"ffn": p}, cfg)["ffn"]
    assert set(d) == set(jd) and "w_gate" not in d
    for k in ("w_gate_q", "w_up_q", "w_down_q"):
        want = np.asarray(jd[k])
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(d[k].numpy(), want)
    jyd, _ = apply(jd, jnp.asarray(x), jcfg)
    yd, _ = moe.moe_apply(d, torch.from_numpy(x), cfg)
    _close(yd, jyd)
    _close(yd, y.detach().numpy())


def test_binary_dense_batched_exact_with_repro_grads():
    x = _x((3, 5, 64), 5, 0.8)
    w = _x((3, 64, 7), 6, 0.8)
    g = _x((3, 5, 7), 7)
    jy, pull = jax.vjp(lambda x, w: j_ops.binary_dense_batched(x, w, mode="int8"),
                       jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = pull(jnp.asarray(g))
    xt, wt = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = ops.binary_dense_batched(xt, wt)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    gx, gw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    _close(gx, jgx)
    _close(gw, jgw)
    for mode, wq in (("int8", j_ops.pack_signs_int8(jnp.asarray(w))),
                     ("xnor", j_ops.pack_bits(jnp.swapaxes(jnp.asarray(w), 1, 2)))):
        want = j_ops.binary_dense_batched_deployed(jnp.asarray(x), wq, mode=mode)
        got = ops.binary_dense_batched_deployed(torch.from_numpy(x), _port(wq))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def jparams():
    """A whole smoke model's params from repro, f32 (block 1 the binary MoE,
    block 2 a float MoE)."""
    return jax.jit(j_get_model(_cfgs()[0]).init)(jax.random.PRNGKey(0))


def test_deploy_and_convert_round_trip(jparams):
    """A whole MoE model in xnor mode: repro's deployed params carried over
    equal the port's deploy of repro's latents carried over, leaf for leaf
    (packed uint32 words as int32); the MoE stacks come across one (E, K, N)
    per layer, not packed by pack_tree."""
    pol = dict(binary_ffn=True, edge_blocks_float=1, binary_mode="xnor")
    jcfg, cfg = _cfgs()
    jcfg = jcfg.replace(policy=jcfg.policy.__class__(**pol))
    cfg = cfg.replace(policy=PrecisionPolicy(**pol))
    latent = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                             packed=False)
    moe_blk = latent["blocks"][1]["ffn"]
    assert moe_blk["w_gate"].shape == (cfg.n_experts, cfg.d_model, cfg.moe_d_ff)
    assert "s_mid" in moe_blk and moe_blk["router"]["w"].dtype == torch.float32
    got = dict(tree_leaves_with_path(deploy_params(latent, cfg)))
    want = dict(tree_leaves_with_path(params_from_jax(
        jax.tree.map(np.asarray, j_deploy(jparams, jcfg)), cfg, device="cpu", packed=False)))
    assert sorted(got) == sorted(want)
    assert got["blocks/1/ffn/w_gate_q"].shape == (cfg.n_experts, cfg.moe_d_ff, cfg.d_model // 32)
    assert "blocks/1/ffn/w_gate" not in got and "blocks/2/ffn/w_gate" in got
    for path, t in got.items():
        assert t.dtype == want[path].dtype, path
        assert torch.equal(t, want[path]), path
    # serving packs the binary denses only: the MoE stacks stay latent
    served = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    assert set(served["blocks"][1]["ffn"]) == set(moe_blk)


def test_moe_binary_latent_clip(jparams):
    """The port clips a binary MoE layer's expert stacks, and leaves the
    float layers' stacks and the shared experts alone. repro's branch
    (repro/optim/bnn.py:24-28) asks for a 3-D f32 leaf, which its stacked
    (L, E, K, N) segment leaves never are: it clips nothing (ROADMAP C)."""
    cfg = _cfgs()[1]
    big = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 3 if any(getattr(k, "key", None) in ("w_gate", "w_up", "w_down")
                                     for k in path) else a, jparams)
    jout = j_clip(big, moe_binary=True)   # as repro's train step calls it for this config
    assert float(jnp.abs(jout["blocks"]["seg1"]["ffn"]["w_gate"]).max()) > 1.0
    p = params_from_jax(jax.tree.map(np.asarray, big), cfg, device="cpu", packed=False)
    out = clip_latent_weights(p)
    binary_blk, float_blk = out["blocks"][1]["ffn"], out["blocks"][2]["ffn"]
    assert "s_mid" in binary_blk and "s_mid" not in float_blk
    for k in ("w_gate", "w_up", "w_down"):
        assert float(binary_blk[k].abs().max()) <= 1.0
        assert float(p["blocks"][1]["ffn"][k].abs().max()) > 1.0   # the input is not changed
        assert float_blk[k] is p["blocks"][2]["ffn"][k]
    for name in ("w_gate", "w_up", "w_down"):
        assert (binary_blk["shared"][name]["w"]
                is p["blocks"][1]["ffn"]["shared"][name]["w"])
    # a layer is binary by its s_mid: without it the same stacks stay as they are
    unmarked = {k: v for k, v in p["blocks"][1]["ffn"].items() if k != "s_mid"}
    assert clip_latent_weights({"ffn": unmarked})["ffn"]["w_gate"] is unmarked["w_gate"]
