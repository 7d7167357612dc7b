"""Layer norm, cross-attention, whisper-base and llama-3.2-vision-11b in the
port against repro, at the smoke configs, in f32, on repro's params carried
over by ``params_from_jax``.

  * layernorm_apply (eps 1e-5, with rows whose variance is near eps, where
    rmsnorm's 1e-6 would show), sinusoidal_positions and cross_attention
    (plain, with and without kv_len, S != T, GQA) equal to repro's; B3's
    plain version non-causal at S != T with T off its block against the
    Pallas kernel's XLA blockwise twin;
  * whisper and the VLM (its gates set away from their zero init, so the
    cross blocks reach the logits): the param trees as the port's own init
    builds them, prefill logits and prefill(S - 1) then decode(1) within
    1e-4 of their max-abs with the same argmax, the loss within 1e-5 and
    every grad leaf within 1e-4 of its max-abs; a whisper decoder of three
    stacked segments (its binary block in the middle) splits back layer for
    layer;
  * whisper with an int8 kv_cache, the slot engine on whisper and the VLM,
    and the serving launcher on whisper-base refuse with repro's messages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as j_smoke  # noqa: E402
from repro.kernels.flash_attention import blockwise_attention_xla  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.nn import attention as j_attn  # noqa: E402
from repro.nn import layers as j_nn  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_plain  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.nn import attention as attn_lib  # noqa: E402
from repro_torch.nn import layers as nn  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402
from repro_torch.tree import tree_leaves_with_path, tree_map  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
B, S = 2, 12


# ---------------------------------------------------------------------------
# layers and attention
# ---------------------------------------------------------------------------

def test_layernorm_matches_repro():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 512)).astype(np.float32)
    x[1] *= 3e-3                  # variance ~1e-5: eps 1e-5 against 1e-6 shows here
    p = {"scale": rng.standard_normal(512).astype(np.float32),
         "bias": rng.standard_normal(512).astype(np.float32)}
    want = np.asarray(j_nn.layernorm_apply(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = nn.layernorm_apply(tp, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    off = nn.layernorm_apply(tp, torch.from_numpy(x), eps=1e-6)
    assert float((off - got).abs().max()) > 1e-2      # the eps is not rmsnorm's
    jb = np.asarray(j_nn.layernorm_apply(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    gb = nn.layernorm_apply(tp, torch.from_numpy(x).to(torch.bfloat16))
    assert gb.dtype == torch.bfloat16
    np.testing.assert_allclose(gb.float().numpy(), jb, rtol=1e-2, atol=1e-2)
    init = nn.layernorm_init(512, device="cpu")
    assert {k: v.dtype for k, v in init.items()} == {"scale": torch.float32,
                                                      "bias": torch.float32}


@pytest.mark.parametrize("length,dim", [(1500, 512), (7, 64)])
def test_sinusoidal_positions_match_repro(length, dim):
    got = nn.sinusoidal_positions(length, dim)
    want = np.asarray(j_nn.sinusoidal_positions(length, dim))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # the f32 angle pos * div carries exp's last-ulp difference times the
    # position: up to ~1e-4 rad at position 1500 (numpy's own table is as
    # far from either)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-7 * length)


def _qkv(seed, s=5, t=37, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, s, hq, d), (B, t, hkv, d), (B, t, hkv, d))]


@pytest.mark.parametrize("kv_len", [None, [37, 11]])
def test_cross_attention_matches_repro(kv_len):
    q, k, v = _qkv(0)
    jkvl = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    want = j_attn.cross_attention(*map(jnp.asarray, (q, k, v)), kv_len=jkvl, impl="xla_ref")
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    got = attn_lib.cross_attention(*map(torch.from_numpy, (q, k, v)), kv_len=kvl)
    assert got.shape == (B, 5, 4, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # B3's plain version, non-causal, S != T, T = 37 off its 16-key block,
    # against the Pallas kernel's XLA twin (its own tests' plain reference)
    twin = blockwise_attention_xla(*map(jnp.asarray, (q, k, v)), causal=False, kv_len=jkvl,
                                   q_block=16, kv_block=16)
    plain = flash_attention_plain(*map(torch.from_numpy, (q, k, v)), causal=False,
                                  kv_len=kvl, q_block=16, kv_block=16)
    for ref in (want, twin):
        np.testing.assert_allclose(plain.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

F32 = dict(compute_dtype="float32", param_dtype="float32")
MODELS = ["whisper-base", "llama-3.2-vision-11b"]
_PAIRS: dict = {}


def _inputs(cfg, seed=0, s=S):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, s)).astype(np.int32)}
    if cfg.family == "whisper":
        b["frames"] = rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    else:
        b["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return b


def _pair(arch):
    if arch not in _PAIRS:
        jcfg = j_smoke(arch).replace(**F32)
        japi = j_get_model(jcfg)
        jparams = japi.init(jax.random.PRNGKey(0))        # eager: quicker than a compile
        if "cross" in jparams:
            # the gates start at 0 (tanh 0 = 0): open them, so that every
            # cross block reaches the logits
            n = jparams["cross"]["gate_attn"].shape[0]
            jparams["cross"]["gate_attn"] = jnp.linspace(0.8, -0.5, n, dtype=jnp.float32)
            jparams["cross"]["gate_ffn"] = jnp.linspace(0.6, 0.3, n, dtype=jnp.float32)
        cfg = smoke_config(arch).replace(**F32)
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
        _PAIRS[arch] = (jcfg, japi, jparams), (cfg, get_model(cfg), params)
    return _PAIRS[arch]


@pytest.fixture(params=MODELS)
def pair(request):
    return _pair(request.param)


def _logits_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL * np.abs(want).max())
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def _shapes(tree):
    return sorted((path, tuple(t.shape), str(t.dtype)) for path, t in tree_leaves_with_path(tree))


def test_prefill_then_decode_match_repro(pair):
    (_, japi, jparams), (cfg, api, params) = pair
    # params_from_jax splits every stack: the tree the port's own init builds
    assert _shapes(params) == _shapes(api.init(0, device="cpu"))
    if cfg.family == "whisper":
        assert len(params["enc_blocks"]) == cfg.enc_layers
        assert len(params["dec_blocks"]) == cfg.n_layers
    else:
        assert len(params["cross"]) == cfg.n_layers // cfg.cross_every
    b = _inputs(cfg)
    jb = jax.tree.map(jnp.asarray, b)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    jprefill = jax.jit(lambda p, b: japi.prefill(p, b, max_len=S + 4))
    gold, _ = jprefill(jparams, jb)
    logits, _ = api.prefill(params, tb, max_len=S + 4)
    _logits_close(logits, gold)
    jshort = {**jb, "tokens": jb["tokens"][:, :-1]}
    _, jcaches = jprefill(jparams, jshort)
    jgot, _ = jax.jit(japi.decode)(jparams, jcaches, jb["tokens"][:, -1:])
    _, caches = api.prefill(params, {**tb, "tokens": tb["tokens"][:, :-1]}, max_len=S + 4)
    got, caches = api.decode(params, caches, tb["tokens"][:, -1:])
    _logits_close(got, jgot)
    # and the decode continues the prefill: repro's own parity bar
    assert float((got - logits).abs().max()) < max(2e-2 * float(logits.abs().max()), 5e-2)
    if cfg.family == "whisper":
        assert all(int(c["len"][0]) == S for c in caches)
        assert tuple(caches[0]["ek"].shape) == (B, cfg.n_audio_frames, cfg.n_kv_heads,
                                                cfg.kv_head_dim())


def test_loss_and_grads_match_repro(pair):
    (_, japi, jparams), (cfg, api, _) = pair
    b = _inputs(cfg, seed=1)
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(japi.loss, has_aux=True))(
        jparams, jax.tree.map(jnp.asarray, b))
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu",
                             packed=False)
    loss, m, g = loss_and_grads(api, params, {k: torch.from_numpy(v) for k, v in b.items()})
    assert set(m) == set(jm) == {"ce", "loss"}
    for k in jm:
        assert abs(float(m[k]) - float(jm[k])) <= 1e-5, k
    want = dict(tree_leaves_with_path(params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                                      device="cpu", packed=False)))
    for path, t in tree_leaves_with_path(g):
        w = want.pop(path)
        assert float((t - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30), path
    assert not want
    if cfg.family == "vlm":
        assert all(float(c["gate_attn"].abs()) > 0 for c in g["cross"])
    else:
        assert all(float(blk["attn"]["wq"]["w"].abs().max()) > 0 for blk in g["enc_blocks"])


def test_whisper_stacks_split_in_order():
    """A whisper decoder of three stacked segments (float, binary, float)
    and its encoder stack, built in repro's layout from the port's own
    params (numpy, no jax), come back layer for layer."""
    cfg = smoke_config("whisper-base").replace(
        n_layers=3, policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                                           binary_mode="int8"), **F32)
    params = get_model(cfg).init(0, device="cpu", packed=False)
    assert [("bin_in" in b["ffn"]) for b in params["dec_blocks"]] == [False, True, False]

    def stack(blocks):
        return tree_map(lambda *a: np.stack([t.numpy() for t in a]), *blocks)
    tree = {k: tree_map(lambda t: t.numpy(), v) for k, v in params.items()
            if k not in ("enc_blocks", "dec_blocks")}
    tree["enc_blocks"] = stack(params["enc_blocks"])
    tree["dec_blocks"] = {f"seg{i}": stack([params["dec_blocks"][i]]) for i in range(3)}
    back = dict(tree_leaves_with_path(params_from_jax(tree, cfg, device="cpu", packed=False)))
    for path, want in tree_leaves_with_path(params):
        assert torch.equal(back.pop(path), want), path
    assert not back
    with pytest.raises(ValueError, match="stacked segments"):
        params_from_jax({**tree, "dec_blocks": {"seg0": tree["dec_blocks"]["seg0"]}}, cfg,
                        device="cpu")


# ---------------------------------------------------------------------------
# what repro refuses
# ---------------------------------------------------------------------------

def test_whisper_refuses_a_quantized_kv_cache():
    with pytest.raises(ValueError) as jerr:
        j_get_model(j_smoke("whisper-base").replace(kv_cache="int8"))
    with pytest.raises(ValueError) as err:
        get_model(smoke_config("whisper-base").replace(kv_cache="int8"))
    assert str(err.value) == str(jerr.value)
    # the VLM's self-attention pool takes a codec, as in repro
    assert get_model(smoke_config("llama-3.2-vision-11b").replace(kv_cache="int8")) \
        .cfg.kv_cache == "int8"


@pytest.mark.parametrize("name", ["whisper-base", "llama-3.2-vision-11b"])
def test_engine_refuses_as_repro(name):
    (_, japi, jparams), (_, api, params) = _pair(name)
    with pytest.raises(ValueError) as jerr:
        JaxEngine(japi, jparams, max_batch=2, max_len=32)
    with pytest.raises(ValueError) as err:
        ServeEngine(api, params, max_batch=2, max_len=32)
    # the same words; the baseline engine it names is the port's own
    assert str(err.value) == str(jerr.value).replace("repro.serving", "repro_torch.serving")


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_serve_launcher_refuses_as_repro(arch, capsys):
    argv = ["--arch", arch, "--smoke"]
    with pytest.raises(SystemExit) as jexit:
        j_serve.main(argv)
    jmsg = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as exit_:
        serve.main(argv + ["--device", "cpu"])
    msg = capsys.readouterr().err.splitlines()[-1]
    assert exit_.value.code == jexit.value.code == 2
    assert msg.split(": error: ")[1] == jmsg.split(": error: ")[1]
    assert "needs audio/image inputs" in msg
