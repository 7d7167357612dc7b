"""Interleaved and chunked prefill and the SLO scheduler in the port,
mirroring tests/test_interleave.py against repro.

On the session ``trained_lm`` (tests/conftest.py: f32 params, float FFNs)
carried over by ``params_from_jax``: the slice functions' logits are held to
repro's within 1e-4; the interleaved engine is held token for token to the
port's blocking engine over {bf16, int8} x {contiguous, paged + prefix} x
{plain, spec}, plus sampled, and to repro's interleaved engine in two cells;
the SLO scheduler's picks equal repro's on seeded random queues.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import transformer as jt  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro.serving import scheduler as jsched  # noqa: E402
from repro.serving.scheduler import AdmissionError as JaxAdmissionError  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import (AdmissionError, FifoScheduler, Request,  # noqa: E402
                                           SloScheduler, make_buckets)

torch.set_num_threads(2)


def _markov(start, n, vocab):
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return np.asarray(out, np.int32)


@pytest.fixture(scope="module")
def models(trained_lm):
    jcfg, japi, jparams = trained_lm
    cfg = smoke_config("stablelm-3b").replace(
        policy=PrecisionPolicy(), compute_dtype="float32", param_dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, japi, jparams, cfg, get_model(cfg), params


@pytest.fixture(scope="module")
def prompts(models):
    cfg = models[3]
    # mixed lengths: padded buckets, multi-slice jobs (bucket 16 at chunk 4
    # = 4 slices) and several admission waves through max_batch=2
    return [_markov(3 + i, 7 + (i % 4), cfg.vocab) for i in range(5)]


def _outputs(api, params, prompts, *, temperature=0.0, engine=ServeEngine, **kw):
    eng = engine(api, params, max_batch=2, max_len=64, temperature=temperature, seed=11,
                 **kw)
    rids = [eng.add_request(p, max_new=8) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids], eng


# ---------------------------------------------------------------------------
# the slice functions against repro's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_slices_and_chunked_prefill_equal_repro(models, codec):
    """Slice by slice (chunk 4 over a padded bucket of 16, rows of true
    length 13, 6, 1 and 16), the taken last hidden states, the finished
    logits and every layer's lengths equal repro's; lm_prefill_chunked's
    logits equal repro's and the slices' bit for bit."""
    jcfg, _, jparams, cfg, _, params = models
    jcfg, cfg = jcfg.replace(kv_cache=codec), cfg.replace(kv_cache=codec)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (4, 16)).astype(np.int32)
    lens = np.asarray([13, 6, 1, 16], np.int32)
    jc, jh = jt.lm_prefill_slice_init(jcfg, 4, 32)
    tc, th = tt.lm_prefill_slice_init(cfg, 4, 32, device="cpu")
    tlens = torch.from_numpy(lens)
    for pos in range(0, 16, 4):
        jh, jc = jt.lm_prefill_slice(jparams, jcfg, jc, jnp.asarray(toks[:, pos:pos + 4]),
                                     jh, jnp.asarray(lens), jnp.asarray(pos, jnp.int32))
        th, tc = tt.lm_prefill_slice(params, cfg, tc, torch.from_numpy(toks[:, pos:pos + 4]),
                                     th, tlens, pos)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4, rtol=1e-4)
        assert [int(c["len"][0]) for c in tc] == [pos + 4] * cfg.n_layers
    jl, jc = jt.lm_prefill_slice_finish(jparams, jcfg, jc, jh, jnp.asarray(lens))
    tl, tc = tt.lm_prefill_slice_finish(params, cfg, tc, th, tlens)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)
    for c in tc:
        assert c["len"].tolist() == lens.tolist()
    for leaf in jax.tree_util.tree_leaves_with_path(jc):
        if "len" in jax.tree_util.keystr(leaf[0]):
            assert np.all(np.asarray(leaf[1]) == lens)
    cl, cc = tt.lm_prefill_chunked(params, cfg, torch.from_numpy(toks), max_len=32,
                                   seq_lens=tlens, chunk=4)
    jcl, _ = jt.lm_prefill_chunked(jparams, jcfg, jnp.asarray(toks), max_len=32,
                                   seq_lens=jnp.asarray(lens), chunk=4)
    assert torch.equal(cl, tl)
    np.testing.assert_allclose(cl.numpy(), np.asarray(jcl), atol=1e-4, rtol=1e-4)
    assert all(c["len"].tolist() == lens.tolist() for c in cc)


def test_chunked_prefill_rejects_a_chunk_that_does_not_tile(models):
    cfg, params = models[3], models[5]
    with pytest.raises(ValueError, match="must divide"):
        tt.lm_prefill_chunked(params, cfg, torch.zeros((1, 12), dtype=torch.int32),
                              chunk=8)


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [0, 3], ids=["plain", "spec"])
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_interleave_parity_matrix(models, prompts, codec, pool, spec):
    """Interleaved == blocking, token for token, against the monolithic
    blocking engine (so the comparison spans the slicing and the chunked
    lowering), and the chunked blocking engine's tokens equal both."""
    api, params = models[4], models[5]
    kw = dict(kv_cache=codec, spec_k=spec, kv_block_size=8 if pool == "paged" else 0,
              prefix_cache=pool == "paged")
    ref, _ = _outputs(api, params, prompts, **kw)
    got, eng = _outputs(api, params, prompts, interleave=True, prefill_chunk=4, **kw)
    chunked, _ = _outputs(api, params, prompts, prefill_chunk=4, **kw)
    assert got == ref == chunked, (codec, pool, spec)
    assert eng.stats["prefill_jobs"] > 0 and eng.stats["prefill_slices"] > 0


def test_interleave_sampled_parity(models, prompts):
    """A request's sampled stream is (rid, len(out)): slicing leaves it as
    it is."""
    api, params = models[4], models[5]
    ref, _ = _outputs(api, params, prompts, temperature=0.8)
    got, _ = _outputs(api, params, prompts, temperature=0.8, interleave=True,
                      prefill_chunk=4)
    assert got == ref


@pytest.mark.parametrize("kw", [dict(kv_cache="int8"),
                                dict(kv_block_size=8, prefix_cache=True, spec_k=3)],
                         ids=["int8 contiguous plain", "bf16 paged spec"])
def test_interleave_equals_repro_interleave(models, prompts, kw):
    jcfg, japi, jparams, _, api, params = models
    want, jeng = _outputs(japi, jparams, prompts, engine=JaxEngine, interleave=True,
                          prefill_chunk=4, **kw)
    got, eng = _outputs(api, params, prompts, interleave=True, prefill_chunk=4, **kw)
    assert got == want
    for key in ("prefills", "prefill_jobs", "prefill_slices", "decode_steps", "admitted",
                "prefilled_tokens", "cached_prompt_tokens"):
        assert eng.stats[key] == jeng.stats[key], key


def test_slo_scheduler_degenerates_to_fifo(models, prompts):
    api, params = models[4], models[5]
    ref, _ = _outputs(api, params, prompts)
    got, _ = _outputs(api, params, prompts, interleave=True, prefill_chunk=4,
                      scheduler="slo")
    assert got == ref


def test_decode_never_skipped_while_slicing(models):
    """On every tick that ran a prefill slice the decoding request still
    gained a token: co-scheduling, not alternation."""
    cfg, api, params = models[3], models[4], models[5]
    eng = ServeEngine(api, params, max_batch=2, max_len=160, prefill_chunk=16,
                      interleave=True)
    vid = eng.add_request(_markov(3, 8, cfg.vocab), max_new=40)
    for _ in range(4):
        eng.step()
    eng.add_request(_markov(9, 96, cfg.vocab), max_new=2)
    victim = next(r for r in eng.slots if r is not None and r.rid == vid)
    while eng._jobs or eng.queue:
        before_toks, before_slices = len(victim.out), eng.stats["prefill_slices"]
        eng.step()
        if eng.stats["prefill_slices"] > before_slices:
            assert len(victim.out) == before_toks + 1
    assert eng.stats["prefill_slices"] >= 96 // 16
    assert len(eng.run()[vid]) == 40


def test_interleave_requires_slice_seam(models):
    api, params = models[4], models[5]
    with pytest.raises(ValueError, match="prefill slice"):
        ServeEngine(api._replace(prefill_slice=None), params, max_batch=2, max_len=64,
                    interleave=True)
    with pytest.raises(ValueError, match="slices_per_tick"):
        ServeEngine(api, params, max_batch=2, max_len=64, interleave=True,
                    slices_per_tick=0)
    with pytest.raises(ValueError, match="power of two"):
        ServeEngine(api, params, max_batch=2, max_len=64, prefill_chunk=6)
    with pytest.raises(ValueError, match="chunked prefill"):
        ServeEngine(api._replace(prefill_chunked=None), params, max_batch=2, max_len=64,
                    prefill_chunk=4)
    with pytest.raises(ValueError, match="starvation_limit"):
        ServeEngine(api, params, max_batch=2, max_len=64, scheduler="slo",
                    starvation_limit=0)
    with pytest.raises(ValueError, match="unknown scheduler"):
        ServeEngine(api, params, max_batch=2, max_len=64, scheduler="edf")


# ---------------------------------------------------------------------------
# admission checks and the SLO policy (pure Python)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs,code", [
    (dict(prompt_len=0, max_new=4), "empty_prompt"),
    (dict(prompt_len=8, max_new=0), "bad_max_new"),
    (dict(prompt_len=8, max_new=4, slo="platinum"), "bad_slo"),
    (dict(prompt_len=80, max_new=4), "prompt_too_long"),
    (dict(prompt_len=60, max_new=16), "too_long"),
    (dict(prompt_len=42, max_new=20), "too_long"),
])
def test_check_request_codes_equal_repro(models, kwargs, code):
    _, japi, jparams, _, api, params = models
    spec = 3 if kwargs["prompt_len"] == 42 else 0
    errs = []
    for eng in (JaxEngine(japi, jparams, max_batch=2, max_len=64, spec_k=spec),
                ServeEngine(api, params, max_batch=2, max_len=64, spec_k=spec)):
        with pytest.raises((AdmissionError, JaxAdmissionError)) as ei:
            eng.check_request(**kwargs)
        errs.append(ei.value)
    assert errs[0].code == errs[1].code == code
    assert errs[0].to_dict() == errs[1].to_dict()


def _req(rid, plen, slo, arrival, cls=Request):
    return cls(rid, np.zeros(plen, np.int32), 4, slo=slo, arrival=arrival)


def test_slo_select_equals_repro_on_random_queues():
    """Seeded random queues (mixed classes, lengths and ages), random free
    counts and clocks, with and without the starvation limit firing: the
    port's picks equal repro's, as do its registry counters."""
    from repro.serving.telemetry import MetricsRegistry as JaxRegistry
    from repro_torch.serving.telemetry import MetricsRegistry
    buckets = make_buckets(64)
    jreg, reg = JaxRegistry(), MetricsRegistry()
    js = jsched.SloScheduler(buckets, metrics=jreg, starvation_limit=6)
    ts = SloScheduler(buckets, metrics=reg, starvation_limit=6)
    rng = np.random.default_rng(0)
    classes = ("interactive", "standard", "batch")
    for trial in range(60):
        n = int(rng.integers(1, 10))
        spec = [(int(rng.choice([3, 8, 12, 16, 30])), classes[int(rng.integers(3))],
                 int(rng.integers(0, 12))) for _ in range(n)]
        spec.sort(key=lambda x: x[2])
        jq = [_req(i, *s, cls=jsched.Request) for i, s in enumerate(spec)]
        tq = [_req(i, *s) for i, s in enumerate(spec)]
        free, clock = int(rng.integers(0, 5)), int(rng.integers(0, 20))
        assert ([r.rid for r in ts.select(tq, free, clock=clock)]
                == [r.rid for r in js.select(jq, free, clock=clock)]), trial
    assert reg.to_dict() == jreg.to_dict()
    assert reg.counter("sched_starvation_anchors_total").value > 0


def test_slo_priority_order():
    s = SloScheduler(make_buckets(64))
    q = [_req(0, 8, "batch", 0), _req(1, 8, "standard", 1), _req(2, 8, "interactive", 2)]
    assert [r.rid for r in s.select(q, n_free=2, clock=3)] == [2, 1]


def test_slo_starvation_bound():
    """Past starvation_limit ticks the queue head anchors the group, whatever
    its class."""
    s = SloScheduler(make_buckets(64), starvation_limit=4)
    q = [_req(0, 8, "batch", 0)] + [_req(i, 8, "interactive", i) for i in range(1, 6)]
    assert s.select(q, 1, clock=4)[0].rid == 1
    assert s.select(q, 1, clock=5)[0].rid == 0


def test_slo_fifo_equivalence_single_class():
    buckets = make_buckets(64)
    fifo, slo = FifoScheduler(buckets), SloScheduler(buckets)
    rng = np.random.default_rng(0)
    for trial in range(20):
        q = [_req(i, int(rng.choice([5, 8, 12, 16])), "standard", i) for i in range(8)]
        n = int(rng.integers(1, 9))
        assert ([r.rid for r in slo.select(q, n, clock=trial)]
                == [r.rid for r in fifo.select(q, n)])
