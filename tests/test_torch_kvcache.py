"""The port's KV codecs (bf16, int8, binary) on the contiguous and the paged
pool, against repro.

* Codec units: the timestep insert writes at ``len`` (both pools), the
  dequant-fused decode matches attention over the materialized cache within
  2e-2 (tests/test_kvcache.py's bound; the loss of quantization itself is
  not in it), the paged decode matches the contiguous one, and pool bytes
  are bytes_per_token x tokens, at full width by arithmetic on the meta
  device.
* Decode on the *same* encoded cache: repro's prefill cache, converted by
  ``caches_from_jax``, decodes in the port to repro's logits within 1e-4
  (f32 model; the two packages' floats differ by ~1e-6 before each new
  token's quantization).
* Token parity on the ``trained_lm`` fixture (tests/conftest.py): int8
  greedy equals repro's bf16 greedy over 36 steps; binary stays within
  tests/test_kvcache.py's documented tolerance (first step <= 0.45x, 32
  teacher-forced steps <= 1.0x the largest |logit|); prefill logits are
  equal across codecs; and the greedy cells of tests/test_engine_parity.py's
  matrix ({bf16, int8} x {contiguous, paged, block 8}) give repro's bf16
  contiguous engine's tokens.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import get_model as j_get_model  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.kernels.kv_decode import gather_pages  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import caches_from_jax, params_from_jax  # noqa: E402
from repro_torch.nn import attention as attn_lib  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

torch.set_num_threads(2)

CODECS = ("bf16", "int8", "binary")
D = 16


def _rand_kv(b=2, t=32, h=4, d=D, seed=0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(np.float32)).to(dtype)
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((b, 1, 2 * h, d)).astype(np.float32)).to(dtype)
    return k, v, q


def _markov(start, n, vocab):
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return np.asarray(out, np.int32)


# ---------------------------------------------------------------------------
# codec units
# ---------------------------------------------------------------------------

def _paged_layer(codec, k, v, lens, *, block=8, holes=1):
    """A paged layer holding k/v (B, T, ...) in shuffled blocks, with
    ``holes`` extra free slots (all-hole table rows)."""
    b, t = k.shape[:2]
    n_pages = t // block
    n_blocks = b * n_pages
    cache = kvc.init_paged(codec, n_blocks, block, k.shape[2], k.shape[3], b + holes,
                           n_pages, k.dtype, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(3).permutation(n_blocks)).to(torch.int32)
    rows = perm.reshape(b, n_pages)
    kvc.paged_insert_prefill([cache], [codec.from_prefill(k, v, t)], rows)
    kvc.paged_update_slots([cache], rows, torch.tensor(lens), torch.arange(b))
    return cache


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("name", CODECS)
def test_insert_timestep_writes_at_len(name, pool):
    codec = kvc.get_codec(name)
    k, v, _ = _rand_kv()
    kn, vn, _ = _rand_kv(t=1, seed=7)
    lens = [20, 30]
    if pool == "contiguous":
        cache = codec.from_prefill(k, v, 32)
        cache["len"] = torch.tensor(lens, dtype=torch.int32)
        before = codec.materialize(dict(cache), head_dim=D)[0].clone()
        out = codec.insert_span(cache, kn, vn)
        km, vm = codec.materialize(out, head_dim=D)
    else:
        cache = _paged_layer(codec, k, v, lens)
        kn, vn = torch.cat([kn, kn[:1]]), torch.cat([vn, vn[:1]])    # + the free slot
        enc = {n: t.clone() for n, t in codec.encoded_leaves(cache).items()}
        table = cache["table"].to(torch.int64)

        def contiguous(c):
            leaves = {n: gather_pages(t, table[:2]) for n, t in c.items()}
            return codec.materialize(leaves, head_dim=D)
        before = contiguous(enc)[0]
        out = kvc.paged_insert_span(cache, kn, vn, codec)
        km, vm = contiguous(codec.encoded_leaves(out))
        # the free slot's row is all holes: its token went to the spare
        # block, and only two positions of the addressed blocks changed
        changed = sum(int((out[n][:-1] != enc[n][:-1]).flatten(2).any(-1).sum())
                      for n in enc if n.startswith("k"))
        assert changed <= 2 * (1 + (name != "bf16"))
    wk, wv = codec.materialize({**codec.encode(kn, vn), "len": None}, head_dim=D)
    assert torch.equal(km[0, 20], wk[0, 0]) and torch.equal(vm[1, 30], wv[1, 0])
    assert out["len"].tolist()[:2] == [21, 31]
    assert torch.equal(km[0, :20], before[0, :20]) and torch.equal(km[0, 21:], before[0, 21:])


@pytest.mark.parametrize("t", [32, 200])      # 200: a ragged last block of the 128
@pytest.mark.parametrize("name", ["int8", "binary"])
def test_fused_decode_matches_attention_over_materialized_cache(name, t):
    codec = kvc.get_codec(name)
    k, v, q = _rand_kv(t=t)
    cache = codec.from_prefill(k, v, t)
    cache["len"] = torch.tensor([t - 12, t], dtype=torch.int32)
    km, vm = codec.materialize(cache, head_dim=D)
    got = codec.decode_attention(q, cache)
    want = attn_lib.decode_attention(q, km, vm, kv_len=cache["len"])
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=0)


@pytest.mark.parametrize("name", CODECS)
def test_paged_decode_matches_contiguous(name):
    """The block-table gather reads what the contiguous pool holds: the same
    fused recurrence over the same values (bf16's contiguous decode takes the
    plain attention instead, so its paged decode is held to it within f32
    rounding)."""
    codec = kvc.get_codec(name)
    k, v, q = _rand_kv(t=32, dtype=torch.float32)
    lens = [19, 32]
    cache = codec.from_prefill(k, v, 32)
    cache["len"] = torch.tensor(lens, dtype=torch.int32)
    paged = _paged_layer(codec, k, v, lens, holes=0)
    got = kvc.paged_decode_attention(q, paged, codec)
    torch.testing.assert_close(got, codec.decode_attention(q, cache), atol=1e-5, rtol=1e-5)


def test_pool_bytes_are_bytes_per_token_times_tokens():
    for name in CODECS:
        codec = kvc.get_codec(name)
        pool = [codec.init(8, 24, 4, 80, device="cpu") for _ in range(2)]
        assert kvc.kv_pool_bytes(pool) == 2 * codec.bytes_per_token(4, 80) * 8 * 24
        parts = kvc.kv_pool_byte_breakdown(pool)
        assert parts["values"] + parts["scales"] == kvc.kv_pool_bytes(pool)
        assert parts["index"] == 2 * 8 * 4


def test_full_width_pool_bytes_on_the_meta_device():
    """stablelm-3b (32 layers, 32 KV heads of 80) at max_batch 8, max_len 256:
    327,680 / 167,936 / 28,672 bytes per token; the paged pool (block 16,
    default n_blocks) holds the same bytes."""
    want = {"bf16": 671_088_640, "int8": 343_932_928, "binary": 58_720_256}
    for name, nbytes in want.items():
        api = get_model(get_config("stablelm-3b").replace(kv_cache=name))
        per_tok = 32 * kvc.get_codec(name).bytes_per_token(32, 80)
        assert per_tok * 8 * 256 == nbytes
        assert kvc.kv_pool_bytes(api.init_cache(8, 256, device="meta")) == nbytes
        assert kvc.kv_pool_bytes(api.init_paged_cache(128, 16, 8, 16, device="meta")) == nbytes
    assert want["bf16"] / want["int8"] == pytest.approx(1.951, abs=1e-3)
    assert want["bf16"] / want["binary"] == pytest.approx(11.43, abs=1e-2)


# ---------------------------------------------------------------------------
# against repro on the trained smoke LM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models(trained_lm):
    """repro's trained LM and the port's copy of it, with an in-distribution
    prompt (it follows the training map x -> 7x + 13)."""
    jcfg, _, jparams = trained_lm
    cfg = smoke_config("stablelm-3b").replace(
        policy=PrecisionPolicy(), compute_dtype="float32", param_dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, jparams, cfg, params, _markov(3, 8, cfg.vocab)[None]


def _greedy(cfg, params, toks, kv, steps):
    api = get_model(cfg.replace(kv_cache=kv))
    logits, caches = api.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=64)
    out = []
    for _ in range(steps):
        nxt = torch.argmax(logits, -1).to(torch.int32)[:, None]
        out.append(int(nxt[0, 0]))
        logits, caches = api.decode(params, caches, nxt)
    return out


def test_int8_greedy_equals_repro_bf16_over_36_steps(models):
    jcfg, jparams, cfg, params, toks = models
    japi = j_get_model(jcfg.replace(kv_cache="bf16"))
    logits, caches = jax.jit(lambda p, t: japi.prefill(p, {"tokens": t}, max_len=64))(
        jparams, jnp.asarray(toks))
    dec = jax.jit(japi.decode)
    want = []
    for _ in range(36):
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        want.append(int(nxt[0, 0]))
        logits, caches = dec(jparams, caches, nxt)
    assert _greedy(cfg, params, toks, "int8", 36) == want


def test_binary_within_documented_tolerance_and_prefill_exact(models):
    """Teacher-forced with the bf16 greedy tokens, as tests/test_kvcache.py:
    the first decode step within 0.45x and 32 steps within 1.0x of the
    largest |logit|. Prefill attends with unquantized K/V, so its logits are
    the same under every codec."""
    _, _, cfg, params, toks = models
    apis = {kv: get_model(cfg.replace(kv_cache=kv)) for kv in CODECS}
    batch = {"tokens": torch.from_numpy(toks)}
    pre = {kv: api.prefill(params, batch, max_len=64) for kv, api in apis.items()}
    assert torch.equal(pre["bf16"][0], pre["int8"][0])
    assert torch.equal(pre["bf16"][0], pre["binary"][0])
    (lb, cb), (lq, cq) = pre["bf16"], pre["binary"]
    maxd, scale = 0.0, 0.0
    for t in range(32):
        nxt = torch.argmax(lb, -1).to(torch.int32)[:, None]
        lb, cb = apis["bf16"].decode(params, cb, nxt)
        lq, cq = apis["binary"].decode(params, cq, nxt)
        d, top = float((lb - lq).abs().max()), float(lb.abs().max())
        if t == 0:
            assert d <= 0.45 * top
        maxd, scale = max(maxd, d), max(scale, top)
    assert maxd <= 1.0 * scale


@pytest.mark.parametrize("name", CODECS)
def test_decode_on_repro_cache_matches_repro(models, name):
    """The port decodes repro's own encoded prefill cache (converted, uint32
    words to int32 bit views) to repro's logits."""
    jcfg, jparams, cfg, params, _ = models
    japi = j_get_model(jcfg.replace(kv_cache=name))
    api = get_model(cfg.replace(kv_cache=name))
    rng = np.random.default_rng(5)
    lens = np.array([11, 6], np.int32)
    toks = np.zeros((2, 16), np.int32)
    for b, n in enumerate(lens):
        toks[b, :n] = rng.integers(0, cfg.vocab, n)
    jlogits, jcaches = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=24,
                                    seq_lens=jnp.asarray(lens))
    caches = caches_from_jax(jax.tree.map(np.asarray, jcaches), cfg, device="cpu")
    assert [c["len"].tolist() for c in caches] == [lens.tolist()] * cfg.n_layers
    nxt = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]
    for _ in range(3):
        jlogits, jcaches = japi.decode(jparams, jcaches, jnp.asarray(nxt))
        logits, caches = api.decode(params, caches, torch.from_numpy(nxt))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-4, atol=1e-4)
        nxt = np.array(jnp.argmax(jlogits, -1), np.int32)[:, None]


@pytest.fixture(scope="module")
def matrix(trained_lm, models):
    """tests/test_engine_parity.py's prompts and repro's bf16 contiguous
    engine's greedy outputs for them."""
    _, japi, jparams = trained_lm
    _, _, cfg, params, _ = models
    prompts = [_markov(3 + i, 7 + (i % 4), cfg.vocab) for i in range(5)]
    eng = JaxEngine(japi, jparams, max_batch=2, max_len=64, kv_cache="bf16")
    rids = [eng.add_request(p, max_new=8) for p in prompts]
    res = eng.run()
    return get_model(cfg), params, prompts, [res[r] for r in rids]


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_engine_parity_matrix_greedy(matrix, codec, pool):
    api, params, prompts, want = matrix
    eng = ServeEngine(api, params, max_batch=2, max_len=64, kv_cache=codec,
                      kv_block_size=8 if pool == "paged" else 0)
    rids = [eng.add_request(p, max_new=8) for p in prompts]
    res = eng.run()
    assert [res[r] for r in rids] == want


def test_engine_kv_bytes_and_refusals(matrix):
    api, params, prompts, _ = matrix
    engs = {kv: ServeEngine(api, params, max_batch=4, max_len=64, kv_cache=kv)
            for kv in CODECS}
    for kv, eng in engs.items():
        assert eng.stats["kv_bytes"] == kvc.kv_pool_bytes(eng.caches)
    # the quantized layouts do not depend on the compute dtype (f32 here,
    # where the bf16 codec stores f32)
    for kv in ("int8", "binary"):
        assert engs[kv].stats["kv_bytes"] == (3 * kvc.get_codec(kv).bytes_per_token(4, 16)
                                              * 4 * 64)
    with pytest.raises(ValueError, match="prefix_cache requires kv_block_size"):
        ServeEngine(api, params, max_batch=2, max_len=32, prefix_cache=True)
    with pytest.raises(ValueError, match="unknown kv cache codec"):
        ServeEngine(api, params, max_batch=2, max_len=32, kv_cache="fp4")
