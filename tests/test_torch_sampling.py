"""Sampled decoding in the port against JAX and repro.

* ``prng_key``, ``fold_in`` and ``random_bits`` (serving/sampling.py, a port
  of JAX's threefry2x32 in its default partitionable layout) give
  ``jax.random``'s bits exactly, over several seeds, request ids, steps and
  a vocabulary-sized shape; ``uniform`` too, in f32 and bf16.
* ``gumbel`` within 1e-6 (absolute and relative) of ``jax.random.gumbel``:
  the two packages' logs differ by an ulp.
* ``categorical`` draws JAX's tokens from the trained smoke LM's logits.
* The port's sampled engine emits repro's sampled engine's tokens
  (temperature 0.8, seed 5), token for token, on the trained LM.
* A request's sampled output depends only on (params, prompt, seed, rid):
  the same across max_batch 1 and 4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

torch.set_num_threads(2)

SEEDS = (0, 5, 123456789, 2 ** 32 - 1)
VOCAB = 50432                      # stablelm-3b's padded vocabulary


def _markov(start, n, vocab):
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return np.asarray(out, np.int32)


def _jkey(seed, rid, step):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rid), step)


def _tkey(seed, rid, step):
    return sampling.fold_in(sampling.fold_in(sampling.prng_key(seed), rid), step)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_bits_equal_jax(seed):
    assert sampling.prng_key(seed).tolist() == np.asarray(jax.random.PRNGKey(seed)).tolist()
    for rid in (0, 3, 1000):
        for step in (0, 1, 17):
            jk, tk = _jkey(seed, rid, step), _tkey(seed, rid, step)
            assert tk.tolist() == np.asarray(jk).tolist()
            bits = sampling.random_bits(tk, (VOCAB,))
            assert np.array_equal(bits.numpy(), np.asarray(jax.random.bits(jk, (VOCAB,))))
    jk, tk = _jkey(seed, 7, 2), _tkey(seed, 7, 2)
    assert np.array_equal(sampling.random_bits(tk, (3, 5, 7)).numpy(),
                          np.asarray(jax.random.bits(jk, (3, 5, 7))))
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = sampling.uniform(tk, (4096,), dt).float().numpy()
        want = np.asarray(jax.random.uniform(jk, (4096,), jdt).astype(jnp.float32))
        assert np.array_equal(got, want)


def test_batched_keys_equal_per_row_keys():
    """One call for a batch of (rid, step) rows draws each row's own bits."""
    rids, steps = torch.tensor([7, 2, 0, 7]), torch.tensor([1, 4, 0, 2])
    keys = sampling.stream_keys(sampling.prng_key(5), rids, steps)
    bits = sampling.random_bits(keys, (300,))
    for i, (r, s) in enumerate(zip(rids.tolist(), steps.tolist())):
        assert keys[i].tolist() == np.asarray(_jkey(5, r, s)).tolist()
        assert np.array_equal(bits[i].numpy(), np.asarray(jax.random.bits(_jkey(5, r, s),
                                                                           (300,))))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_gumbel_within_an_ulp_of_jax(seed):
    for rid, step in ((0, 0), (3, 9), (77, 1)):
        got = sampling.gumbel(_tkey(seed, rid, step), (VOCAB,)).numpy()
        want = np.asarray(jax.random.gumbel(_jkey(seed, rid, step), (VOCAB,), jnp.float32))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models(trained_lm):
    jcfg, japi, jparams = trained_lm
    cfg = smoke_config("stablelm-3b").replace(
        policy=PrecisionPolicy(), compute_dtype="float32", param_dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, japi, jparams, cfg, get_model(cfg), params


def test_categorical_equals_jax_on_trained_lm_logits(models):
    jcfg, japi, jparams, _, _, _ = models
    toks = np.stack([_markov(3 + i, 8, jcfg.vocab) for i in range(4)])
    logits, caches = japi.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=16)
    rows = [np.asarray(logits)]
    nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    for _ in range(2):
        logits, caches = japi.decode(jparams, caches, nxt)
        rows.append(np.asarray(logits))
        nxt = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    logits = np.concatenate(rows)                          # (12, Vp)
    rids = np.arange(len(logits)) % 5
    steps = np.arange(len(logits)) // 2
    for t in (0.8, 1.0):
        want = [int(jax.random.categorical(_jkey(5, int(r), int(s)), jnp.asarray(row) / t))
                for r, s, row in zip(rids, steps, logits)]
        got = sampling.sample_rows(torch.from_numpy(logits), sampling.prng_key(5),
                                   torch.from_numpy(rids), torch.from_numpy(steps), t)
        assert got.tolist() == want


def _serve(engine_cls, api, params, prompts, **kw):
    eng = engine_cls(api, params, max_len=64, temperature=0.8, seed=5, **kw)
    rids = [eng.add_request(p, max_new=10) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_sampled_engine_equals_repro(models, kv):
    jcfg, japi, jparams, _, api, params = models
    prompts = [_markov(3 + i, 8 + (i % 3), jcfg.vocab) for i in range(5)]
    want = _serve(JaxEngine, japi, jparams, prompts, max_batch=2, kv_cache=kv)
    got = _serve(ServeEngine, api, params, prompts, max_batch=2, kv_cache=kv)
    assert got == want


def test_sampled_output_depends_only_on_request(models):
    """(params, prompt, seed, rid) alone decide a request's tokens: a pool of
    one slot and a pool of four give the same outputs."""
    jcfg, _, _, _, api, params = models
    prompts = [_markov(5 + 2 * i, 6 + i, jcfg.vocab) for i in range(5)]
    one = _serve(ServeEngine, api, params, prompts, max_batch=1)
    four = _serve(ServeEngine, api, params, prompts, max_batch=4)
    assert one == four
    greedy = ServeEngine(api, params, max_batch=4, max_len=64)
    rids = [greedy.add_request(p, max_new=10) for p in prompts]
    res = greedy.run()
    assert [res[r] for r in rids] != one            # the temperature does something
