"""The port's LM against repro's on the same weights.

``smoke_config("stablelm-3b")`` in f32, with its int8 binary FFN kept (the
middle block is binary), params initialized by repro and carried over by
``params_from_jax``. A right-padded batch is prefilled and then decoded
for 4 steps; the logits and every layer's cache must match repro within
1e-4.

Why the binary FFN can be held to a float tolerance here: the int8 dot is
exact in both packages, so the only float differences come before
``sign()`` (attention, RoPE, norms summing in another order, ~1e-6). A
value within that distance of 0 would flip a sign and move a logit by
O(1); with these inputs none is, which is what the 1e-4 asserts.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.models import lm_common as j_lc  # noqa: E402
from repro_torch.configs import PrecisionPolicy, smoke_config  # noqa: E402
from repro_torch.models import get_model, lm_common as lc  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
MAX_LEN = 24


@pytest.fixture(scope="module")
def pair():
    kw = dict(compute_dtype="float32", param_dtype="float32")
    jcfg = j_smoke("stablelm-3b").replace(**kw)
    japi = j_get_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = smoke_config("stablelm-3b").replace(**kw)
    assert cfg.policy.block_is_binary(1, cfg.n_layers)      # int8 FFN kept
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return (jcfg, japi, jparams), (cfg, get_model(cfg), params)


def _check_caches(jcaches, caches, cfg):
    """repro's stacked seg{i} caches against the port's per-layer list."""
    layer = 0
    for si, (_, _, count) in enumerate(lc.build_segments(cfg)):
        seg = jcaches[f"seg{si}"]
        for i in range(count):
            for name in ("k", "v"):
                np.testing.assert_allclose(caches[layer][name].numpy(),
                                           np.asarray(seg[name][i]),
                                           rtol=TOL, atol=TOL)
            np.testing.assert_array_equal(caches[layer]["len"].numpy(),
                                          np.asarray(seg["len"][i]))
            layer += 1
    assert layer == len(caches) == cfg.n_layers


def test_prefill_and_decode_match_repro(pair):
    (jcfg, japi, jparams), (cfg, api, params) = pair
    rng = np.random.default_rng(0)
    lens = np.array([12, 7, 3], np.int32)
    toks = np.zeros((3, 16), np.int32)            # right-padded to a bucket
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab, n)
    jlogits, jcaches = japi.prefill(jparams, {"tokens": jnp.asarray(toks)},
                                    max_len=MAX_LEN, seq_lens=jnp.asarray(lens))
    logits, caches = api.prefill(params, {"tokens": torch.from_numpy(toks)},
                                 max_len=MAX_LEN, seq_lens=torch.from_numpy(lens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=TOL, atol=TOL)
    _check_caches(jcaches, caches, cfg)

    nxt = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
    for _ in range(4):
        jlogits, jcaches = japi.decode(jparams, jcaches, jnp.asarray(nxt))
        logits, caches = api.decode(params, caches, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=TOL, atol=TOL)
        _check_caches(jcaches, caches, cfg)
        nxt = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]


def test_attention_block_matches_repro(pair):
    """gqa_apply (full-sequence causal attention, no cache) on layer 0."""
    (jcfg, _, jparams), (cfg, _, params) = pair
    x = np.random.default_rng(1).standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["seg0"])["attn"]
    want = j_lc.gqa_apply(jp, jnp.asarray(x), jcfg, positions=jnp.arange(10))
    got = lc.gqa_apply(params["blocks"][0]["attn"], torch.from_numpy(x), cfg,
                       positions=torch.arange(10))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_bf16_params_carry_over_bit_for_bit():
    jcfg = j_smoke("stablelm-3b")                           # bf16 params
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(3))
    cfg = smoke_config("stablelm-3b")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    table = params["embed"]["table"]
    assert table.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        table.view(torch.int16).numpy(),
        np.asarray(jparams["embed"]["table"]).view(np.int16))
    # the binary block's packed words are repro's pack_bits of its latent
    from repro.core.binarize import pack_bits as j_pack_bits
    seg1 = jax.tree.map(lambda a: a[0], jparams["blocks"]["seg1"])
    np.testing.assert_array_equal(
        params["blocks"][1]["ffn"]["bin_in"]["w_packed"].numpy(),
        np.asarray(j_pack_bits(seg1["ffn"]["bin_in"]["w_latent"].T)).view(np.int32))


def test_unported_configs_raise():
    cfg = smoke_config("stablelm-3b")
    # the quantized KV codecs are ported: int8 and binary LMs build
    for kv in ("int8", "binary"):
        assert get_model(cfg.replace(kv_cache=kv)).cfg.kv_cache == kv
    # the XNOR-popcount kernel (B1) is ported: an xnor LM builds
    xnor = cfg.replace(policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                                              binary_mode="xnor"))
    assert get_model(xnor).cfg.policy.binary_mode == "xnor"
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        get_model(cfg.replace(use_mla=True))
    from repro_torch.configs import get_config
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        get_config("qwen3-8b")
