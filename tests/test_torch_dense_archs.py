"""qwen3-8b (qk-norm), qwen2-72b (QKV bias) and deepseek-v3-671b (MLA,
sigmoid-routed MoE, the MTP head) in the port against repro, at their
smoke configs, in f32, on repro's params carried over by
``params_from_jax``. deepseek runs at ``capacity_factor`` 16, as
tests/test_decode_parity.py runs it, so that no capacity drop and no
near-tie in the routing decides a result.

  * the port's configs equal repro's, full and smoke;
  * the param tree as the port's own init builds it; prefill logits, and
    prefill(S - 1) then decode(1), within 1e-4 of their max-abs with the
    same argmax; for the GQA two, also a right-padded prefill, the
    speculative verify, the chunked prefill and the sliced (interleaved)
    prefill, each through qk-norm or the bias;
  * the slot engine's greedy tokens equal repro's engine's on the int8
    pool: qwen2 with ``spec_k=3`` (whose tokens are the plain engine's; the
    draft packs the biased denses, the bias kept in f32), qwen3 on a paged
    int8 pool with the prefix cache (``prefill_ctx``) and interleaved
    prefill;
  * deepseek-v3's loss with the MTP head within 1e-5 (ce, aux, mtp_ce,
    loss) and every grad leaf within 1e-4 of its max-abs, the MTP head's
    included;
  * deployed params (int8, xnor) give the latent forward's logits, as
    tests/test_deploy.py holds repro's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.models import get_model, lm_common as lc  # noqa: E402
from repro_torch.models import transformer as t  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.deploy import deploy_params  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
MAX_LEN = 24
ARCHS = ["qwen3-8b", "qwen2-72b", "deepseek-v3-671b"]
GQA = ARCHS[:2]
NEW_ARCHS = ARCHS + ["whisper-base", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_repro(arch):
    for port, ref in ((get_config(arch), j_get_config(arch)),
                      (smoke_config(arch), j_smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def _f32(arch):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if arch.startswith("deepseek"):
        kw["capacity_factor"] = 16.0
    return kw


_PAIRS: dict = {}
_JIT: dict = {}


def _pair(arch):
    """(repro's cfg, api, params), (the port's cfg, api, params), built once
    an arch."""
    if arch not in _PAIRS:
        kw = _f32(arch)
        jcfg = j_smoke(arch).replace(**kw)
        japi = j_get_model(jcfg)
        # eager is quicker than a compile, but for deepseek's MoE stacks
        init = jax.jit(japi.init) if jcfg.family == "moe" else japi.init
        jparams = init(jax.random.PRNGKey(0))
        if jcfg.qkv_bias:
            # repro inits the biases at zero: give them values, so that the
            # bias reaches every path
            rng = np.random.default_rng(7)
            jparams = jax.tree_util.tree_map_with_path(
                lambda path, a: (jnp.asarray(rng.standard_normal(a.shape) * 0.1, a.dtype)
                                 if getattr(path[-1], "key", None) == "b" else a), jparams)
        cfg = smoke_config(arch).replace(**kw)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _PAIRS[arch] = (jcfg, japi, jparams), (cfg, get_model(cfg), params)
        # repro's prefill (with seq_lens) and decode, compiled once an arch
        _JIT[arch] = (jax.jit(lambda p, t, sl: japi.prefill(p, {"tokens": t}, max_len=MAX_LEN,
                                                            seq_lens=sl)),
                      jax.jit(japi.decode))
    return _PAIRS[arch]


@pytest.fixture(params=ARCHS)
def pair(request):
    return _pair(request.param)


@pytest.fixture(params=GQA)
def gqa_pair(request):
    return _pair(request.param)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def _shapes(tree):
    return sorted((path, tuple(t_.shape), str(t_.dtype))
                  for path, t_ in tree_leaves_with_path(tree))


def _tokens(vocab, b=2, s=17, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def test_prefill_then_decode_match_repro(pair):
    """Prefill logits, and a decode of the last token on the cache of the
    first S - 1 (a prefill of all S tokens with seq_lens S - 1: the same
    cache, and one compile of repro's prefill for both)."""
    (_, japi, jparams), (cfg, api, params) = pair
    assert _shapes(params) == _shapes(api.init(0, device="cpu"))
    toks = _tokens(cfg.vocab)
    s = toks.shape[1]
    jprefill, jdecode = _JIT[cfg.name]
    gold, _ = jprefill(jparams, jnp.asarray(toks), jnp.full((2,), s, jnp.int32))
    logits, _ = api.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN)
    _logits_close(logits, gold)
    _, jcaches = jprefill(jparams, jnp.asarray(toks), jnp.full((2,), s - 1, jnp.int32))
    jgot, _ = jdecode(jparams, jcaches, jnp.asarray(toks[:, -1:]))
    _, caches = api.prefill(params, {"tokens": torch.from_numpy(toks[:, :-1])},
                            max_len=MAX_LEN)
    got, _ = api.decode(params, caches, torch.from_numpy(toks[:, -1:]))
    _logits_close(got, jgot)


def test_gqa_paths_match_repro(gqa_pair):
    """A right-padded prefill, then a 4-token verify on its cache; the
    chunked prefill; the sliced prefill, slice by slice (every one of them
    through gqa_qkv: qk-norm for qwen3, the bias for qwen2)."""
    (_, japi, jparams), (cfg, api, params) = gqa_pair
    lens = np.array([17, 9], np.int32)
    toks = _tokens(cfg.vocab, seed=2)
    jl, jc = _JIT[cfg.name][0](jparams, jnp.asarray(toks), jnp.asarray(lens))
    pl, pc = api.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=MAX_LEN,
                         seq_lens=torch.from_numpy(lens))
    _logits_close(pl, jl)
    wave = _tokens(cfg.vocab, s=4, seed=1)
    jv, _ = jax.jit(japi.verify)(jparams, jc, jnp.asarray(wave))
    v, _ = api.verify(params, pc, torch.from_numpy(wave))
    _logits_close(v, jv)
    # the chunked and the sliced prefill reorder the softmax's sums: held to
    # repro's monolithic prefill, as repro holds its own (1e-4 of max-abs)
    # (the chunks must divide the length: the prompt padded to 24)
    padded = torch.from_numpy(np.pad(toks, ((0, 0), (0, 7))))
    ch, _ = api.prefill_chunked(params, {"tokens": padded}, max_len=MAX_LEN,
                                seq_lens=torch.from_numpy(lens), chunk=8)
    _logits_close(ch, jl)
    caches, h_last = api.prefill_slice_init(2, MAX_LEN, device="cpu")
    for pos in range(0, 24, 8):
        h_last, caches = api.prefill_slice(params, caches, padded[:, pos:pos + 8],
                                           h_last, torch.from_numpy(lens), pos)
    sl, _ = api.prefill_slice_finish(params, caches, h_last, torch.from_numpy(lens))
    _logits_close(sl, jl)


ENGINE_CASES = [("qwen2-72b", dict(kv_cache="int8", spec_k=3)),
                ("qwen3-8b", dict(kv_cache="int8", kv_block_size=8, prefix_cache=True,
                                  interleave=True))]


@pytest.mark.parametrize("arch,kw", ENGINE_CASES,
                         ids=["qwen2 int8 spec 3", "qwen3 paged int8 prefix interleave"])
def test_engine_tokens_match_repro(arch, kw):
    (_, japi, jparams), (cfg, api, params) = _pair(arch)
    rng = np.random.default_rng(3)
    header = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([header, rng.integers(0, cfg.vocab, n)]) for n in (5, 11, 3)]
    out = []
    for eng in (JaxEngine(japi, jparams, max_batch=2, max_len=48, **kw),
                ServeEngine(api, params, max_batch=2, max_len=48, **kw)):
        rids = [eng.add_request(p, max_new=5) for p in prompts]
        res = eng.run()
        out.append(([res[r] for r in rids], dict(eng.stats)))
    (want, jstats), (got, stats) = out
    assert got == want
    for key in ("decode_steps", "prefills", "generated_tokens", "kv_bytes", "spec_accepted",
                "cached_prompt_tokens", "prefill_slices"):
        assert stats.get(key) == jstats.get(key), key


def test_mtp_loss_and_grads_match_repro():
    """deepseek-v3's smoke model: MLA in every block, a dense and three
    sigmoid-routed MoE blocks (a binary one among them), and the MTP
    head, whose block and projection get gradients."""
    (jcfg, japi, jparams), (cfg, api, _) = _pair("deepseek-v3-671b")
    b = next(SyntheticTokens(cfg.vocab, 16, 2, seed=0))
    (jloss, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, b))
    assert "mtp_ce" in jm
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                             packed=False)
    loss, m, g = loss_and_grads(api, params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(m) == set(jm) == {"ce", "aux", "mtp_ce", "loss"}
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5, k
    assert abs(float(m["loss"]) - float(m["ce"] + 0.01 * m["aux"] + 0.3 * m["mtp_ce"])) <= 1e-6
    want = dict(tree_leaves_with_path(params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                                      device="cpu", packed=False)))
    for path, t_ in tree_leaves_with_path(g):
        w = want.pop(path)
        assert float((t_ - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30), path
    assert not want
    assert g["mtp"]["proj"]["w"].abs().max() > 0
    assert g["mtp"]["block"]["attn"]["w_uk"]["w"].abs().max() > 0


def test_serving_ignores_the_mtp_head():
    """The MTP head changes no serving logits, as in repro (its params are
    not read outside the loss)."""
    (_, _, _), (cfg, api, params) = _pair("deepseek-v3-671b")
    toks = torch.from_numpy(_tokens(cfg.vocab))
    want, _ = api.prefill(params, {"tokens": toks}, max_len=MAX_LEN)
    got, _ = api.prefill({k: v for k, v in params.items() if k != "mtp"}, {"tokens": toks},
                         max_len=MAX_LEN)
    assert torch.equal(got, want)
    assert set(params["mtp"]) == {"proj", "block", "ln"}
    assert tuple(params["mtp"]["proj"]["w"].shape) == (2 * cfg.d_model, cfg.d_model)
    assert t._mtp_sig(cfg) == lc.BlockSig("mla", "float", False)


@pytest.mark.parametrize("arch,mode", [("qwen3-8b", "int8"), ("qwen3-8b", "xnor"),
                                       ("deepseek-v3-671b", "int8")])
def test_deployed_equals_latent_forward(arch, mode):
    """tests/test_deploy.py's check, on the port: the same tolerance at the
    smoke config's own dtypes."""
    cfg = smoke_config(arch)
    cfg = cfg.replace(policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                                             binary_mode=mode), capacity_factor=16.0)
    api = get_model(cfg)
    latent = api.init(0, device="cpu", packed=False)
    dparams = deploy_params(latent, cfg)
    assert not any("w_latent" in p for p, _ in tree_leaves_with_path(dparams))
    assert any(k in p for p, _ in tree_leaves_with_path(dparams)
               for k in ("w_int8", "w_packed", "_q"))
    toks = torch.from_numpy(_tokens(cfg.vocab, s=16, seed=1))
    gold, _ = api.prefill(latent, {"tokens": toks}, max_len=20)
    got, _ = api.prefill(dparams, {"tokens": toks}, max_len=20)
    np.testing.assert_allclose(got.float().numpy(), gold.float().numpy(), rtol=2e-2, atol=2e-2)
    dd = api.init_deployed(0, device="cpu")
    assert [p for p, _ in tree_leaves_with_path(dd)] == \
        [p for p, _ in tree_leaves_with_path(dparams)]
