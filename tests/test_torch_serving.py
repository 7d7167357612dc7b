"""The port's ServeEngine against repro's: the same greedy tokens in the
scenarios of tests/test_serving_engine.py, on the session ``trained_lm``
(tests/conftest.py: f32 params, float FFN) carried over by
``params_from_jax``.

Token identity is exact, no tolerance: the trained model's top-2 logit gaps
are several logits wide, far above the ~1e-6 by which the two packages'
f32 forwards differ. (The fixture's docstring says why the binary-FFN model
cannot carry a claim of token identity across frameworks: sign() turns a
1-ulp difference into an O(1) jump.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro.serving.scheduler import AdmissionError as JaxAdmissionError  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import AdmissionError  # noqa: E402

torch.set_num_threads(2)

STATS = ("decode_steps", "occupied_slot_steps", "prefills", "admitted",
         "evictions", "generated_tokens", "prefilled_tokens", "kv_bytes")


def _markov(start, n, vocab):
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return np.asarray(out, np.int32)


@pytest.fixture(scope="module")
def engines(trained_lm):
    """Factories for a repro engine and a port engine on the same weights."""
    jcfg, japi, jparams = trained_lm
    cfg = smoke_config("stablelm-3b").replace(
        policy=PrecisionPolicy(), compute_dtype="float32", param_dtype="float32")
    api = get_model(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")

    def make(attn_impl=None, **kw):
        return (JaxEngine(japi, jparams, **kw),
                ServeEngine(api, params, attn_impl=attn_impl, **kw))
    return make, cfg.vocab


def _drive(eng, reqs):
    rids = [eng.add_request(p, max_new=mn, **kw) for p, mn, kw in reqs]
    res = eng.run()
    return [res[r] for r in rids]


def _same(jeng, teng, reqs):
    want, got = _drive(jeng, reqs), _drive(teng, reqs)
    assert got == want
    for key in STATS:
        assert teng.stats[key] == jeng.stats[key], key
    return got


@pytest.mark.parametrize("attn_impl", [None, "flash"])
def test_mixed_lengths(engines, attn_impl):
    """attn_impl="flash" sends prefill through the flash wrapper, which on
    the CPU runs the kernel's plain version."""
    make, vocab = engines
    reqs = [(_markov(3 + i, plen, vocab), mn, {})
            for i, (plen, mn) in enumerate([(3, 2), (5, 4), (9, 3), (12, 5),
                                            (4, 1), (7, 6)])]
    out = _same(*make(attn_impl=attn_impl, max_batch=3, max_len=64), reqs)
    assert [len(o) for o in out] == [2, 4, 3, 5, 1, 6]


def test_join_mid_decode(engines):
    make, vocab = engines
    outs = []
    for eng in make(max_batch=2, max_len=64):
        r_a = eng.add_request(_markov(5, 9, vocab), max_new=10)
        eng.step()
        eng.step()
        r_b = eng.add_request(_markov(11, 7, vocab), max_new=6)  # joins mid-decode
        res = eng.run()
        outs.append((res[r_a], res[r_b]))
    assert outs[0] == outs[1]


def test_eviction_and_reuse(engines):
    make, vocab = engines
    reqs = [(_markov(2 + i, 6, vocab), mn, {}) for i, mn in enumerate([1, 2, 3, 4, 5])]
    jeng, teng = make(max_batch=2, max_len=64)
    _same(jeng, teng, reqs)
    assert teng.stats["evictions"] == 5 and teng.stats["prefills"] >= 3
    assert teng.utilization() == pytest.approx(jeng.utilization())


def test_stop_tokens(engines):
    make, vocab = engines
    prompt = _markov(4, 6, vocab)
    jeng, teng = make(max_batch=2, max_len=64)
    base = _same(jeng, teng, [(prompt, 10, {})])[0]
    reqs = [(prompt, 10, {"stop_tokens": {base[3]}}),          # mid-decode stop
            (prompt, 10, {"stop_tokens": {base[0]}}),          # stops at prefill
            (_markov(9, 6, vocab), 7, {}),
            (prompt, 10, {"stop_tokens": {vocab + 5}})]        # never fires
    out = _same(*make(max_batch=2, max_len=64), reqs)
    assert out[0] == base[:base.index(base[3]) + 1] and out[1] == [base[0]]


@pytest.mark.parametrize("prompt,max_new,code", [
    (np.arange(30), 8, "too_long"),
    (np.arange(40), 1, "prompt_too_long"),
    (np.array([], np.int32), 4, "empty_prompt"),
    (np.arange(4), 0, "bad_max_new"),
])
def test_bad_requests_raise_admission_error(engines, prompt, max_new, code):
    make, _ = engines
    jeng, teng = make(max_batch=2, max_len=32)
    with pytest.raises(JaxAdmissionError) as jerr:
        jeng.add_request(prompt, max_new=max_new)
    with pytest.raises(AdmissionError) as err:
        teng.add_request(prompt, max_new=max_new)
    assert err.value.code == jerr.value.code == code
    assert err.value.to_dict() == jerr.value.to_dict()


def test_unported_engine_options_raise(engines):
    """Only a mesh is refused now (ROADMAP A9); interleaved and chunked
    prefill, the SLO scheduler and telemetry (A6), sampling and speculation
    (A5) construct and serve."""
    from repro_torch.serving.telemetry import Telemetry
    make, vocab = engines
    _, teng = make(max_batch=2, max_len=32)
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        ServeEngine(teng.api, teng.params, max_batch=2, max_len=32, mesh=object())
    want = _drive(teng, [(_markov(3, 9, vocab), 4, {})])
    for kw in ({"interleave": True}, {"interleave": True, "prefill_chunk": 4},
               {"scheduler": "slo"}, {"telemetry": Telemetry()},
               {"temperature": 0.5}, {"spec_k": 2}):
        eng = ServeEngine(teng.api, teng.params, max_batch=2, max_len=32, **kw)
        got = _drive(eng, [(_markov(3, 9, vocab), 4, {})])
        assert len(got[0]) == 4
        if "temperature" not in kw:
            assert got == want, kw
