"""zamba2-2.7b (Mamba2 with the shared attention block) and rwkv6-3b in the
port against repro, at the smoke configs in f32, on repro's params carried
over by ``params_from_jax``; repro's functions are jitted once per module.

  * prefill logits and caches, then 4 decode steps (logits every step, the
    caches after the last), within 1e-4 of their max-abs (rwkv6: below)
    with the same argmax: zamba2 on the bf16 pool and on the int8 pool (its shared
    block's codes within one step of repro's, the codec's scales 1e-4),
    rwkv6 on its state; the param trees as the port's own init builds them;
  * the loss within 1e-5 and every grad leaf within 1e-4 of its max-abs
    (rwkv6: below, with float denses);
  * deployed params (zamba2 int8, rwkv6 xnor: tests/test_deploy.py's
    cells): the ``{"bin": ...}`` denses quantized, no latent left, bit for
    bit repro's, prefill logits within the family's bar of repro's deployed
    ones and within
    tests/test_deploy.py's 2e-2 of the latent forward; the latent clip
    reaches the nested latents as repro's does;
  * the bucket engine's greedy tokens equal repro's (three length groups,
    one larger than max_batch, mixed max_new);
  * the serving launcher falls back to the bucket engine with repro's
    warning and serves; the slot engine refuses both families and
    get_model refuses a codec for rwkv6, with repro's messages.

rwkv6's bars are bf16's, not f32's: its time-mix projections and ``c_r``
round to bf16 in both packages whatever the config says
(repro/models/rwkv6.py:107-110, :117, :131 take nn.dense_apply's default
compute dtype), so one ulp of f32 noise in what they read (a layer norm's sum,
~5e-7) moves a product across a bf16 rounding edge now and then, by 2^-8
of it. Over the smoke model's three blocks that leaves logits and states
~4e-3 of their max-abs apart, and with float denses the loss ~1e-3 (of
~5.5) and the grads of the bf16 products' weights ~2e-2
(tests/test_torch_ssm.py holds each block to 1e-4 on the same inputs,
time_mix bit for bit): rwkv6 is held to 2^-7 with the same argmax, 5e-3
(2^-10 of the loss) and 2^-5. Its loss and grads are compared with float
denses: the binary channel-mix turns that noise into sign flips, and 1e-7
of relative noise in every param moves the binary latents' grads by ~0.9
of their max-abs on the CPU alone. zamba2 has no such rounding: 1e-4,
1e-5 and 1e-4, its binary blocks included.
"""

import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.configs.base import PrecisionPolicy as JPolicy  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models.deploy import deploy_params as j_deploy  # noqa: E402
from repro.optim.bnn import clip_latent_weights as j_clip  # noqa: E402
from repro.serving import BucketEngine as JaxBucketEngine  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import caches_from_jax, params_from_jax  # noqa: E402
from repro_torch.models.deploy import deploy_params  # noqa: E402
from repro_torch.optim.bnn import clip_latent_weights  # noqa: E402
from repro_torch.serving.bucket import BucketEngine  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

torch.set_num_threads(2)

F32 = dict(compute_dtype="float32", param_dtype="float32")
# relative to the max-abs of logits and cache leaves, the loss (absolute),
# each grad leaf relative to its max-abs (module note)
TOLS = {"zamba2-2.7b": {"out": 1e-4, "loss": 1e-5, "grad": 1e-4},
        "rwkv6-3b": {"out": 2 ** -7, "loss": 5e-3, "grad": 2 ** -5}}
B, S, MAX_LEN, STEPS = 2, 12, 20, 4
ARCHS = ["zamba2-2.7b", "rwkv6-3b"]
_PAIRS: dict = {}


def _pair(arch, binary: bool = True):
    """repro's smoke model in f32 (its params) and the port's on the same
    params, packed; ``binary=False``: the float-dense policy."""
    if (arch, binary) not in _PAIRS:
        jcfg, cfg = j_smoke(arch).replace(**F32), smoke_config(arch).replace(**F32)
        if not binary:
            jcfg, cfg = jcfg.replace(policy=JPolicy()), cfg.replace(policy=PrecisionPolicy())
        japi = j_get_model(jcfg)
        jparams = jax.jit(japi.init)(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _PAIRS[arch, binary] = (jcfg, japi, jparams), (cfg, get_model(cfg), params)
    return _PAIRS[arch, binary]


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1e-30))


def _logits_close(got, want, tol=TOLS["zamba2-2.7b"]["out"]):
    _close(got, want, tol)
    np.testing.assert_array_equal(got.numpy().argmax(-1), np.asarray(want).argmax(-1))


def _caches_close(got, jcaches, cfg):
    """Every cache leaf within the family's bar of its max-abs; int8 codes
    within one step (the K/V they encode differ by f32 noise between the
    packages), lengths exact."""
    tol = TOLS[cfg.name]["out"]
    want = dict(tree_leaves_with_path(caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg,
                                                      device="cpu")))
    for path, t in tree_leaves_with_path(got):
        w = want.pop(path)
        assert t.shape == w.shape and t.dtype == w.dtype, path
        if t.dtype == torch.int8:
            assert int((t.int() - w.int()).abs().max()) <= 1, path
            assert float((t != w).float().mean()) < 0.01, path
        elif not t.is_floating_point():
            assert torch.equal(t, w), path
        else:
            _close(t, w.float().numpy(), tol)
    assert not want


def _shapes(tree):
    return sorted((path, tuple(t.shape), str(t.dtype)) for path, t in tree_leaves_with_path(tree))


@pytest.mark.parametrize("arch,kv", [("zamba2-2.7b", "auto"), ("zamba2-2.7b", "int8"),
                                     ("rwkv6-3b", "auto")])
def test_prefill_then_decode_match_repro(arch, kv):
    (jcfg, _, jparams), (cfg, _, params) = _pair(arch)
    japi, api = j_get_model(jcfg.replace(kv_cache=kv)), get_model(cfg.replace(kv_cache=kv))
    # params_from_jax splits every run / segment: the tree the port's own
    # init builds
    assert _shapes(params) == _shapes(api.init(0, device="cpu"))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S + STEPS)).astype(np.int32)
    jlogits, jcaches = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, max_len=MAX_LEN))(
        jparams, jnp.asarray(toks[:, :S]))
    logits, caches = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :S])},
                                 max_len=MAX_LEN)
    tol = TOLS[arch]["out"]
    _logits_close(logits, jlogits, tol)
    _caches_close(caches, jcaches, cfg)
    jdecode = jax.jit(japi.decode)
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        jlogits, jcaches = jdecode(jparams, jcaches, jnp.asarray(tok))
        logits, caches = api.decode(params, caches, torch.from_numpy(tok))
        _logits_close(logits, jlogits, tol)
    _caches_close(caches, jcaches, cfg)
    if cfg.family == "mamba2_hybrid":
        assert len(caches["mamba"]) == cfg.n_layers
        assert len(caches["attn"]) == cfg.n_layers // cfg.attn_every
        assert all(int(c["len"][0]) == S + STEPS for c in caches["attn"])
        want = "k" if kv == "auto" else "k_q"
        assert want in caches["attn"][0], list(caches["attn"][0])
    else:
        assert len(caches) == cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_repro(arch):
    # rwkv6 with float denses: its binary channel-mix turns bf16-edge noise
    # into sign flips, and 1e-7 of relative noise in every param moves its
    # binary latents' grads by ~0.9 of their max-abs (module note)
    (_, japi, jparams), (cfg, api, _) = _pair(arch, binary=arch != "rwkv6-3b")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    b = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    (jloss, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, b))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                             packed=False)
    loss, m, g = loss_and_grads(api, params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(m) == set(jm) == {"ce", "loss"}
    tol = TOLS[arch]
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= tol["loss"], k
    want = dict(tree_leaves_with_path(params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                                      device="cpu", packed=False)))
    for path, t in tree_leaves_with_path(g):
        w = want.pop(path)
        assert float((t - w).abs().max()) <= tol["grad"] * max(float(w.abs().max()), 1e-30), \
            path
    assert not want
    if cfg.family == "mamba2_hybrid":
        # the binary blocks' latents get the STE's gradient
        binary = [blk for blk in g["blocks"] if "bin" in blk["in_zx"]]
        assert binary and all(float(blk[k]["bin"]["w_latent"].abs().max()) > 0
                              for blk in binary for k in ("in_zx", "out"))


@pytest.mark.parametrize("arch,mode", [("zamba2-2.7b", "int8"), ("rwkv6-3b", "xnor")])
def test_deployed_params_match_repro(arch, mode):
    """tests/test_deploy.py's cells: the deployed forward = repro's deployed
    forward (1e-4) and the latent forward (2e-2, tests/test_deploy.py)."""
    jcfg = j_smoke(arch).replace(policy=JPolicy(binary_ffn=True, edge_blocks_float=1,
                                                binary_mode=mode), **F32)
    cfg = smoke_config(arch).replace(policy=PrecisionPolicy(binary_ffn=True,
                                                            edge_blocks_float=1,
                                                            binary_mode=mode), **F32)
    japi, api = j_get_model(jcfg), get_model(cfg)
    jparams = _pair(arch)[0][2]
    jdep = j_deploy(jparams, jcfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                             packed=False)
    dep = deploy_params(params, cfg)
    paths = [path for path, _ in tree_leaves_with_path(dep)]
    assert not any("w_latent" in p for p in paths)
    q = "w_int8" if mode == "int8" else "w_packed"
    assert any(p.endswith(f"bin/{q}") for p in paths)
    # the deployed leaves are repro's (uint32 words as int32 with the same bits)
    jleaves = dict(tree_leaves_with_path(params_from_jax(jax.tree.map(np.asarray, jdep), cfg,
                                                         device="cpu", packed=False)))
    for path, t in tree_leaves_with_path(dep):
        assert torch.equal(t, jleaves.pop(path)), path
    assert not jleaves
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, 16)).astype(np.int32)
    jgot, _ = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, max_len=20))(
        jdep, jnp.asarray(toks))
    got, _ = api.prefill(dep, {"tokens": torch.from_numpy(toks)}, max_len=20)
    _logits_close(got, jgot, TOLS[arch]["out"])
    gold, _ = api.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=20)
    np.testing.assert_allclose(got.numpy(), gold.numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_latent_clip_reaches_the_nested_latents(arch):
    (_, _, jparams), (cfg, _, _) = _pair(arch)
    big = jax.tree.map(lambda a: a * 3, jparams)
    want = params_from_jax(jax.tree.map(np.asarray, j_clip(big)), cfg, device="cpu",
                           packed=False)
    p = params_from_jax(jax.tree.map(np.asarray, big), cfg, device="cpu", packed=False)
    out = clip_latent_weights(p)
    want = dict(tree_leaves_with_path(want))
    n_latent = 0
    for path, t in tree_leaves_with_path(out):
        assert torch.equal(t, want.pop(path)), path
        n_latent += path.endswith("bin/w_latent")
    assert n_latent == 2 * sum(cfg.policy.block_is_binary(i, cfg.n_layers)
                               for i in range(cfg.n_layers))


def _drive(eng, prompts, max_news):
    rids = [eng.add_request(p, max_new=mn) for p, mn in zip(prompts, max_news)]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("arch,kv", [("zamba2-2.7b", None), ("zamba2-2.7b", "int8"),
                                     ("rwkv6-3b", None)])
def test_bucket_engine_equals_repro(arch, kv):
    (_, japi, jparams), (cfg, api, params) = _pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 9, 5, 5, 12, 9)]
    max_news = [3, 6, 1, 4, 5, 2]
    kw = dict(max_batch=2, max_len=32, kv_cache=kv)
    want = _drive(JaxBucketEngine(japi, jparams, **kw), prompts, max_news)
    got = _drive(BucketEngine(api, params, **kw), prompts, max_news)
    assert got == want


def test_serve_launcher_falls_back_to_the_bucket_engine(caplog):
    with caplog.at_level(logging.WARNING, logger="repro_torch.serve"):
        res = serve.main(["--arch", "rwkv6-3b", "--smoke", "--device", "cpu", "--requests",
                          "3", "--prompt-lens", "4,6", "--max-new", "3"])
    # repro's warning, word for word (repro/launch/serve.py:205-207)
    assert "family 'rwkv6' has no slot-indexed cache insert; falling back to the bucket " \
           "engine" in caplog.messages
    assert sorted(res) == [0, 1, 2] and all(len(t) == 3 for t in res.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_engine_refuses_as_repro(arch):
    (_, japi, jparams), (_, api, params) = _pair(arch)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(japi, jparams, max_batch=2, max_len=32)
    with pytest.raises(ValueError) as err:
        ServeEngine(api, params, max_batch=2, max_len=32)
    assert str(err.value) == str(jerr.value).replace("repro.serving", "repro_torch.serving")


def test_rwkv6_refuses_a_codec_as_repro():
    for kv in ("int8", "binary"):
        with pytest.raises(ValueError) as jerr:
            j_get_model(j_smoke("rwkv6-3b").replace(kv_cache=kv))
        with pytest.raises(ValueError) as err:
            get_model(smoke_config("rwkv6-3b").replace(kv_cache=kv))
        assert str(err.value) == str(jerr.value)
    # zamba2's shared block takes one, as in repro
    assert get_model(smoke_config("zamba2-2.7b").replace(kv_cache="int8")).cfg.kv_cache == "int8"
