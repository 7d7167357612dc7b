"""Speculative decoding in the port (serving/spec.py, the verify path, the
engine's waves), mirroring tests/test_spec_decode.py against repro.

Token identity with the plain engine is the bar, not a tolerance: every
emitted token is drawn from the target's logits on the request's own
(rid, step) stream, so speculation changes how many tokens a wave banks,
never which. Parity runs on the trained smoke LM (f32, float FFNs:
tests/conftest.py), whose argmax margins dominate the ~1e-6 differences
between the one-pass verify and sequential decode; the verify's logits are
held to those of sequential decode within 1e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro.serving.spec import binarize_draft_params as j_binarize  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models import lm_common as lc  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.scheduler import AdmissionError, accept_wave  # noqa: E402
from repro_torch.serving.spec import (binarize_draft_params, draft_param_bytes,  # noqa: E402
                                      make_draft_wave)

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


# ---------------------------------------------------------------------------
# the accept rule and the draft
# ---------------------------------------------------------------------------

def test_accept_wave_rule():
    assert accept_wave([5, 6, 7, 8], [5, 6, 7]) == [5, 6, 7, 8]
    assert accept_wave([5, 9, 7, 8], [5, 6, 7]) == [5, 9]
    assert accept_wave([4, 6, 7, 8], [5, 6, 7]) == [4]
    assert accept_wave([3], []) == [3]
    assert accept_wave([1, 2, 3], [9, 9]) == [1]


def test_draft_aliases_and_packs_as_repro(models):
    """The draft aliases every non-FFN tensor (``is``), and each float FFN
    matrix packs to repro's words exactly, its scale within f32 rounding."""
    jcfg, _, jparams, cfg, _, params = models
    draft = binarize_draft_params(params, cfg)
    jdraft = j_binarize(jparams, jcfg)
    assert draft["embed"]["table"] is params["embed"]["table"]
    layer = 0
    for si, (_, _, count) in enumerate(lc.build_segments(cfg)):
        jffn = jdraft["blocks"][f"seg{si}"]["ffn"]
        for i in range(count):
            blk, tblk = draft["blocks"][layer], params["blocks"][layer]
            assert blk["attn"] is tblk["attn"] and blk["ln1"] is tblk["ln1"]
            for k in ("w_gate", "w_up", "w_down"):
                assert set(blk["ffn"][k]) == {"w_packed", "scale"}
                words = np.asarray(jffn[k]["w_packed"][i]).view(np.int32)
                assert np.array_equal(blk["ffn"][k]["w_packed"].numpy(), words)
                np.testing.assert_allclose(blk["ffn"][k]["scale"].numpy(),
                                           np.asarray(jffn[k]["scale"][i]), rtol=1e-6)
            layer += 1
    assert 0 < draft_param_bytes(draft) < params["embed"]["table"].numel() * 4


def test_draft_keeps_already_binary_ffns_as_is():
    cfg = smoke_config("stablelm-3b")            # the middle block's FFN is binary
    params = get_model(cfg).init(0, device="cpu")
    draft = binarize_draft_params(params, cfg)
    kinds = []
    for blk, dblk in zip(params["blocks"], draft["blocks"]):
        if "bin_in" in blk["ffn"]:
            assert dblk["ffn"] is blk["ffn"]
            kinds.append("binary")
        else:
            assert "w_packed" in dblk["ffn"]["w_gate"]
            kinds.append("float")
    assert kinds == ["float", "binary", "float"]
    # the binary FFNs' packed copy belongs to the target, not to the draft
    assert draft_param_bytes(draft) == sum(
        d["ffn"][k]["w_packed"].numel() * 4 + d["ffn"][k]["scale"].numel() * 4
        for d in draft["blocks"][::2] for k in ("w_gate", "w_up", "w_down"))


# ---------------------------------------------------------------------------
# the verify step: one pass == sequential decode
# ---------------------------------------------------------------------------

def _paged_from(api, caches, lens, block=8):
    """The contiguous prefill caches moved into a paged pool (block 8,
    shuffled blocks), lengths ``lens``."""
    b, t = caches[0]["len"].shape[0], next(v for k, v in caches[0].items()
                                           if k != "len").shape[1]
    n_pages = t // block
    pool = api.init_paged_cache(b * n_pages, block, b, n_pages, device="cpu")
    rows = torch.from_numpy(np.random.default_rng(1).permutation(b * n_pages)
                            .astype(np.int32).reshape(b, n_pages))
    kvc.paged_insert_prefill(pool, caches, rows)
    kvc.paged_update_slots(pool, rows, torch.tensor(lens, dtype=torch.int32), torch.arange(b))
    return pool


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "binary"])
def test_verify_matches_sequential_decode(models, kv, pool):
    jcfg, _, _, cfg, _, params = models
    api = get_model(cfg.replace(kv_cache=kv))
    toks = torch.from_numpy(np.stack([_markov(3, 8, jcfg.vocab), _markov(5, 8, jcfg.vocab)]))

    def fresh():
        logits, caches = api.prefill(params, {"tokens": toks}, max_len=32)
        if pool == "paged":
            caches = _paged_from(api, caches, [8, 8])
        return logits, caches
    logits, caches = fresh()
    fed, seq_logits = [torch.argmax(logits, -1).to(torch.int32)[:, None]], []
    for _ in range(3):
        lg, caches = api.decode(params, caches, fed[-1])
        seq_logits.append(lg)
        fed.append(torch.argmax(lg, -1).to(torch.int32)[:, None])
    _, caches2 = fresh()
    ptrs = [c["len"].data_ptr() for c in caches2]
    vl, caches2 = api.verify(params, caches2, torch.cat(fed[:3], dim=1))
    assert vl.shape == (2, 3, seq_logits[0].shape[-1])
    for j in range(3):
        assert torch.equal(vl[:, j].argmax(-1), seq_logits[j].argmax(-1))
        torch.testing.assert_close(vl[:, j], seq_logits[j], atol=1e-4, rtol=0)
    assert [c["len"].tolist() for c in caches2] == [[11, 11]] * cfg.n_layers
    assert [c["len"].data_ptr() for c in caches2] == ptrs


def test_verify_refused_for_mla():
    with pytest.raises(ValueError, match="GQA"):
        lc.block_verify({}, None, None, lc.BlockSig("mla", "float"), {})


# ---------------------------------------------------------------------------
# the draft wave == k sequential decodes (tokens and every cache leaf)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_draft_wave_matches_sequential_decodes(models, temperature, pool):
    jcfg, _, _, cfg, _, params = models
    api = get_model(cfg.replace(kv_cache="int8"))
    draft = binarize_draft_params(params, cfg)
    k, seed_key = 3, sampling.prng_key(5)
    toks = torch.from_numpy(np.stack([_markov(3, 8, jcfg.vocab), _markov(5, 8, jcfg.vocab)]))
    rids, base_steps = torch.tensor([7, 2], dtype=torch.int32), torch.tensor([1, 4])

    def fresh():
        logits, caches = api.prefill(params, {"tokens": toks}, max_len=32)
        if pool == "paged":
            caches = _paged_from(api, caches, [8, 8])
        return torch.argmax(logits, -1).to(torch.int32)[:, None], caches
    first, caches_w = fresh()
    toks_w, caches_w = make_draft_wave(api, k=k, temperature=temperature,
                                       seed_key=seed_key)(draft, caches_w, first, rids,
                                                          base_steps)
    _, caches_s = fresh()
    seq = [first]
    for j in range(k):
        dl, caches_s = api.decode(draft, caches_s, seq[-1])
        if temperature <= 0:
            nxt = torch.argmax(dl, -1).to(torch.int32)
        else:
            nxt = torch.tensor([int(sampling.categorical(
                sampling.fold_in(sampling.fold_in(seed_key, int(r)), int(s) + j), row / temperature))
                for r, s, row in zip(rids, base_steps, dl)], dtype=torch.int32)
        seq.append(nxt[:, None])
    assert torch.equal(toks_w, torch.cat(seq, dim=1))
    for cw, cs in zip(caches_w, caches_s):
        assert cw.keys() == cs.keys()
        for name in cw:
            assert torch.equal(cw[name], cs[name]), name


# ---------------------------------------------------------------------------
# the engine: checks, then token identity with the plain engine
# ---------------------------------------------------------------------------

def test_spec_checks_as_repro(models):
    _, _, _, _, api, params = models
    eng = ServeEngine(api, params, max_batch=2, max_len=32, spec_k=4)
    with pytest.raises(AdmissionError, match="spec_k") as err:
        eng.add_request(np.arange(20), max_new=10)        # fits only without k
    assert err.value.code == "too_long" and err.value.to_dict()["error"]["detail"]["spec_k"] == 4
    eng.add_request(np.arange(18), max_new=10)            # 18 + 10 + 4 <= 32
    with pytest.raises(ValueError, match="spec_k must be >= 0"):
        ServeEngine(api, params, max_batch=2, max_len=32, spec_k=-1)
    with pytest.raises(ValueError, match="speculative draft"):
        ServeEngine(api, params, max_batch=2, max_len=32, spec_k=2, spec_draft="none")
    with pytest.raises(ValueError, match="spec_draft_impl"):
        ServeEngine(api, params, max_batch=2, max_len=32, spec_k=2, spec_draft_impl="fp4")
    with pytest.raises(ValueError, match="verify"):
        ServeEngine(api._replace(verify=None), params, max_batch=2, max_len=32, spec_k=2)


def _outputs(api, params, prompts, *, temperature=0.0, max_new=10, **kw):
    eng = ServeEngine(api, params, max_batch=2, max_len=64, temperature=temperature,
                      seed=5, **kw)
    rids = [eng.add_request(p, max_new=max_new) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids], eng


@pytest.fixture(scope="module")
def spec_prompts(models):
    jcfg = models[0]
    return [_markov(3 + i, 8 + (i % 3), jcfg.vocab) for i in range(5)]


@pytest.fixture(scope="module")
def plain_outputs(models, spec_prompts):
    """The plain engine's outputs per (codec, pool, temperature) cell,
    shared across the draft impls."""
    api, params = models[4], models[5]
    cache = {}

    def get(codec, pool, temperature):
        key = (codec, pool, temperature)
        if key not in cache:
            cache[key] = _outputs(api, params, spec_prompts, temperature=temperature,
                                  kv_cache=codec, kv_block_size=8 if pool == "paged" else 0)[0]
        return cache[key]
    return get


@pytest.mark.parametrize("draft_impl", ["auto", "int8_mxu"])
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("codec", ["bf16", "int8", "binary"])
def test_spec_token_identical_matrix(models, spec_prompts, plain_outputs, codec, pool,
                                     temperature, draft_impl):
    api, params = models[4], models[5]
    want = plain_outputs(codec, pool, temperature)
    got, eng = _outputs(api, params, spec_prompts, temperature=temperature, spec_k=3,
                        spec_draft_impl=draft_impl, kv_cache=codec,
                        kv_block_size=8 if pool == "paged" else 0)
    assert got == want
    assert eng.acceptance_rate() > 0
    assert eng.stats["spec_waves"] == eng.stats["decode_steps"] > 0
    assert eng.stats["spec_draft_launches"] == eng.stats["spec_waves"]
    assert eng.stats["generated_tokens"] == sum(len(o) for o in got)


@pytest.mark.parametrize("codec,pool,temperature", [("bf16", "contiguous", 0.0),
                                                    ("int8", "paged", 0.8)])
def test_spec_engine_equals_repro(models, spec_prompts, codec, pool, temperature):
    """The port's spec engine against repro's: the same tokens, and the
    same drafts accepted."""
    _, japi, jparams, _, api, params = models
    kw = dict(kv_cache=codec, kv_block_size=8 if pool == "paged" else 0, spec_k=3)
    jeng = JaxEngine(japi, jparams, max_batch=2, max_len=64, temperature=temperature,
                     seed=5, **kw)
    rids = [jeng.add_request(p, max_new=10) for p in spec_prompts]
    res = jeng.run()
    got, eng = _outputs(api, params, spec_prompts, temperature=temperature, **kw)
    assert got == [res[r] for r in rids]
    assert eng.stats["spec_accepted"] == jeng.stats["spec_accepted"] > 0
    assert eng.stats["spec_waves"] == jeng.stats["spec_waves"]


def test_spec_banks_several_tokens_a_wave(models, spec_prompts):
    api, params = models[4], models[5]
    _, base = _outputs(api, params, spec_prompts)
    _, spec = _outputs(api, params, spec_prompts, spec_k=3)
    assert spec.stats["decode_steps"] < base.stats["decode_steps"]


def test_spec_with_prefix_cache_parity_and_accounting(models):
    jcfg, _, _, _, api, params = models
    header = _markov(3, 24, jcfg.vocab)
    prompts = [np.concatenate([header, _markov(50 + i, 6, jcfg.vocab)]) for i in range(5)]

    def serve(**kw):
        eng = ServeEngine(api, params, max_batch=2, max_len=64, **kw)
        rids = [eng.add_request(prompts[0], max_new=6)]
        eng.run()
        rids += [eng.add_request(p, max_new=6) for p in prompts[1:]]
        res = eng.run()
        return [res[r] for r in rids], eng

    want, _ = serve()
    got, eng = serve(kv_block_size=8, prefix_cache=True, spec_k=3)
    assert got == want
    assert eng.stats["cached_prompt_tokens"] == 4 * 24
    assert eng.acceptance_rate() > 0
    assert all(n.ref == 0 for n in eng.pool._walk())
    assert eng.pool.tree_blocks() + len(eng.pool.free) == eng.n_blocks


def test_spec_stop_tokens_mid_wave_discard_and_count(models, spec_prompts):
    api, params = models[4], models[5]
    base, _ = _outputs(api, params, spec_prompts)
    stop = base[0][2]
    eng = ServeEngine(api, params, max_batch=2, max_len=64, spec_k=3)
    rids = [eng.add_request(p, max_new=10, stop_tokens={stop}) for p in spec_prompts]
    res = eng.run()
    outs = [res[r] for r in rids]
    for b, o in zip(base, outs):
        assert o == (b[:b.index(stop) + 1] if stop in b else b)
    assert eng.stats["generated_tokens"] == sum(len(o) for o in outs)
