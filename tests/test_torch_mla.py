"""The MLA families in the port against repro: minicpm3-4b (dense, MLA) and
deepseek-v2-236b (MoE, MLA) at their smoke configs, in f32, on repro's
params carried over by ``params_from_jax``. deepseek runs at
``capacity_factor`` 16, as tests/test_decode_parity.py runs it, so that no
capacity drop and no near-tie in the f32 routing decides a result.

  * B3's plain version at MLA's head dims (D 24 = 16 + 8, Dv 16) against
    repro's Pallas kernel (interpret mode) and its XLA blockwise twin,
    causal and with kv_len, within tests/test_attention.py's f32 2e-5; the
    autograd Function's grads at Dv != D against jax.vjp through that
    twin, which the Pallas kernel's backward runs (1e-5);
  * the MLA block, and a right-padded prefill then two decode steps: the
    logits within 1e-4 of their max-abs with the same argmax, and every
    layer's compressed cache (c, kr, len) within 1e-4;
  * the slot engine's greedy tokens and stats equal repro's engine's;
  * lm_loss within 1e-5, every grad leaf within 1e-4 of its max-abs
    (deepseek, whose blocks hold MLA, a binary and a float MoE layer);
  * the serving options an MLA cache cannot take (a paged pool, the prefix
    cache, speculative decoding, chunked and interleaved prefill) raise
    with repro's messages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels.flash_attention import (blockwise_attention_xla,  # noqa: E402
                                           flash_attention_pallas)
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import lm_common as j_lc  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.models import get_model, lm_common as lc  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
MAX_LEN = 24
ARCHS = ["minicpm3-4b", "deepseek-v2-236b"]


# ---------------------------------------------------------------------------
# B3's plain version at Dv != D
# ---------------------------------------------------------------------------

def _qkv(seed, b=2, s=40, h=4, d=24, dv=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, h, d), (b, s, h, dv))]


@pytest.mark.parametrize("kv_len", [None, [40, 13]])
def test_flash_plain_at_mla_head_dims(kv_len):
    q, k, v = _qkv(0)
    scale = 1.0 / np.sqrt(24)
    kw = dict(causal=True, scale=scale)
    jkvl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), kv_len=jkvl, bq=16, bk=16,
                                  interpret=True, **kw)
    twin = blockwise_attention_xla(*map(jnp.asarray, (q, k, v)), kv_len=jkvl, q_block=16,
                                   kv_block=16, **kw)
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), kv_len=kvl, q_block=16,
                                kv_block=16, **kw)
    assert got.shape == (2, 40, 4, 16)
    for ref in (want, twin):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_flash_function_grads_at_mla_head_dims():
    q, k, v = _qkv(1, s=24)
    g = np.random.default_rng(2).standard_normal((2, 24, 4, 16)).astype(np.float32)
    kvl = [24, 9]
    # repro's Pallas kernel takes its backward through this twin
    # (repro/kernels/flash_attention.py:165-191)
    want = jax.jit(lambda q, k, v, g: jax.vjp(lambda q, k, v: blockwise_attention_xla(
        q, k, v, causal=True, kv_len=jnp.asarray(kvl, jnp.int32), q_block=8, kv_block=8),
        q, k, v)[1](g))(*map(jnp.asarray, (q, k, v, g)))
    qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*qkv, causal=True, kv_len=torch.tensor(kvl, dtype=torch.int32))
    assert out.shape == (2, 24, 4, 16)
    got = torch.autograd.grad(out, qkv, torch.from_numpy(g))
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _f32(arch):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if arch.startswith("deepseek"):
        kw["capacity_factor"] = 16.0
    return kw


_PAIRS: dict = {}


def _pair(arch):
    """(repro's cfg, api, params), (the port's cfg, api, params), built once
    an arch."""
    if arch not in _PAIRS:
        kw = _f32(arch)
        jcfg = j_smoke(arch).replace(**kw)
        japi = j_get_model(jcfg)
        jparams = jax.jit(japi.init)(jax.random.PRNGKey(0))
        cfg = smoke_config(arch).replace(**kw)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _PAIRS[arch] = (jcfg, japi, jparams), (cfg, get_model(cfg), params)
    return _PAIRS[arch]


@pytest.fixture(params=ARCHS)
def pair(request):
    return _pair(request.param)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def _check_caches(jcaches, caches, cfg):
    layer = 0
    for si, (sig, _, count) in enumerate(lc.build_segments(cfg)):
        assert sig.attn == "mla"
        seg = jcaches[f"seg{si}"]
        for i in range(count):
            assert set(caches[layer]) == {"c", "kr", "len"}
            for name in ("c", "kr"):
                np.testing.assert_allclose(caches[layer][name].numpy(),
                                           np.asarray(seg[name][i]), rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(caches[layer]["len"].numpy(),
                                          np.asarray(seg["len"][i]))
            layer += 1
    assert layer == len(caches) == cfg.n_layers


def test_mla_block_matches_repro(pair):
    (jcfg, _, jparams), (cfg, _, params) = pair
    x = np.random.default_rng(1).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["seg0"])["attn"]
    want = jax.jit(lambda p, x: j_lc.mla_apply(p, x, jcfg, positions=jnp.arange(10)))(
        jp, jnp.asarray(x))
    got = lc.mla_apply(params["blocks"][0]["attn"], torch.from_numpy(x), cfg,
                       positions=torch.arange(10))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_prefill_and_decode_match_repro(pair):
    (_, japi, jparams), (cfg, api, params) = pair
    rng = np.random.default_rng(0)
    lens = np.array([12, 7, 3], np.int32)
    toks = np.zeros((3, 16), np.int32)            # right-padded to a bucket
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab, n)
    jprefill = jax.jit(lambda p, t, sl: japi.prefill(p, {"tokens": t}, max_len=MAX_LEN,
                                                     seq_lens=sl))
    jdecode = jax.jit(japi.decode)
    jlogits, jcaches = jprefill(jparams, jnp.asarray(toks), jnp.asarray(lens))
    logits, caches = api.prefill(params, {"tokens": torch.from_numpy(toks)},
                                 max_len=MAX_LEN, seq_lens=torch.from_numpy(lens))
    _logits_close(logits, jlogits)
    _check_caches(jcaches, caches, cfg)
    leaves = [c["c"] for c in caches]
    for _ in range(2):
        nxt = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
        jlogits, jcaches = jdecode(jparams, jcaches, jnp.asarray(nxt))
        logits, caches = api.decode(params, caches, torch.from_numpy(nxt))
        _logits_close(logits, jlogits)
        _check_caches(jcaches, caches, cfg)
    # the decode wrote the compressed cache in place
    assert all(c["c"] is t for c, t in zip(caches, leaves))


def test_engine_tokens_match_repro(pair):
    (_, japi, jparams), (cfg, api, params) = pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (5, 11, 3, 9, 14)]
    out = []
    for eng in (JaxEngine(japi, jparams, max_batch=4, max_len=32),
                ServeEngine(api, params, max_batch=4, max_len=32)):
        rids = [eng.add_request(p, max_new=5) for p in prompts]
        res = eng.run()
        out.append(([res[r] for r in rids], dict(eng.stats)))
    (want, jstats), (got, stats) = out
    assert got == want
    for key in ("decode_steps", "prefills", "generated_tokens", "kv_bytes"):
        assert stats[key] == jstats[key], key
    # the compressed pool: kv_lora + rope values a token a layer, in f32 here
    assert stats["kv_bytes"] == cfg.n_layers * 4 * 32 * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4


def test_loss_and_grads_match_repro():
    """deepseek's smoke model holds MLA in every block and a binary and a
    float MoE block, so its loss reaches every new module."""
    (_, japi, jparams), (cfg, api, _) = _pair("deepseek-v2-236b")
    b = next(SyntheticTokens(cfg.vocab, 16, 2, seed=0))
    (jloss, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, b))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                             packed=False)
    loss, m, g = loss_and_grads(api, params, {k: torch.from_numpy(v) for k, v in b.items()})
    for k in ("ce", "aux", "loss"):
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5, k
    assert float(m["aux"]) > 0                       # the balance loss of 2 MoE blocks
    want = dict(tree_leaves_with_path(params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                                      device="cpu", packed=False)))
    for path, t in tree_leaves_with_path(g):
        w = want.pop(path)
        assert float((t - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30), path
    assert not want
    for blk in g["blocks"]:                          # B3's Function reaches every block
        assert blk["attn"]["w_uk"]["w"].abs().max() > 0
    # the binary MoE block's latents get the STE's gradient
    assert g["blocks"][1]["ffn"]["w_gate"].abs().max() > 0


REFUSED = [dict(kv_block_size=8), dict(kv_block_size=8, prefix_cache=True), dict(spec_k=2),
           dict(prefill_chunk=8), dict(interleave=True)]


@pytest.mark.parametrize("kw", REFUSED, ids=["paged", "prefix", "spec", "chunk",
                                             "interleave"])
def test_mla_refuses_what_repro_refuses(pair, kw):
    (_, japi, jparams), (_, api, params) = pair
    with pytest.raises(ValueError) as jerr:
        JaxEngine(japi, jparams, max_batch=2, max_len=32, **kw)
    with pytest.raises(ValueError) as err:
        ServeEngine(api, params, max_batch=2, max_len=32, **kw)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="paged KV pool requires GQA"):
        lc.init_paged_segment_caches(api.cfg, 4, 8, 2, 4, device="cpu")
