"""The functions the engine captures as CUDA graphs (serving/graphs.py), run
eagerly on the CPU on their static buffers.

On a card each decode tick and each speculative wave is one replay of a
graph captured from ``ServeEngine._tick_fn`` / ``_wave_fn``; a replay reads
the tensors the graph captured, so the step must read its inputs from the
engine's static buffers and update the pool in place. Here, on the CPU, the
same step function runs three times on the same buffers and must equal three
ordinary steps through the model API (tokens, lengths and every pool byte),
and no cache leaf or static buffer may be rebound (the same ``data_ptr``).
The card's replays themselves are held in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.graphs import StepGraph  # noqa: E402
from repro_torch.serving.spec import make_spec_wave  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def smoke():
    cfg = smoke_config("stablelm-3b").replace(compute_dtype="float32", param_dtype="float32")
    api = get_model(cfg)
    return api, api.init(0, device="cpu")


def _engine(api, params, **kw):
    """An engine with two requests prefilled into its four slots."""
    eng = ServeEngine(api, params, max_batch=4, max_len=48, **kw)
    rng = np.random.default_rng(2)
    for n in (5, 11):
        eng.add_request(rng.integers(0, api.cfg.vocab, n), max_new=20)
    eng._admit()
    return eng


def _clone(caches):
    return [{k: v.clone() for k, v in c.items()} for c in caches]


def _ptrs(eng):
    return ([t.data_ptr() for c in eng.caches for t in c.values()] +
            [t.data_ptr() for t in (eng._tok, eng._rids, eng._steps, eng._base_lens)])


def _same_pool(a, b):
    for ca, cb in zip(a, b):
        assert ca.keys() == cb.keys()
        for name in ca:
            assert torch.equal(ca[name], cb[name]), name


@pytest.mark.parametrize("kw", [dict(kv_cache="int8"), dict(kv_cache="bf16", kv_block_size=8),
                                dict(kv_cache="binary", temperature=0.8, seed=3)],
                         ids=["int8", "bf16-paged", "binary-sampled"])
def test_tick_fn_equals_three_decode_steps(smoke, kw):
    api, params = smoke
    eng = _engine(api, params, **kw)
    assert isinstance(eng.graph, StepGraph)
    ref = _clone(eng.caches)
    ptrs = _ptrs(eng)
    tok = torch.from_numpy(eng.next_tok.copy())
    rids = torch.tensor([r.rid if r else 0 for r in eng.slots], dtype=torch.int32)
    for step in range(3):
        eng._fill(tok=tok.numpy())
        steps = torch.tensor([len(r.out) + step if r else 0 for r in eng.slots],
                             dtype=torch.int32)
        eng._fill(rids=rids.numpy(), steps=steps.numpy())
        (got,) = eng._step_fn()
        logits, ref = eng.api.decode(params, ref, tok)
        if eng.temperature > 0:
            want = sampling.sample_rows(logits, sampling.prng_key(3), rids, steps, 0.8)
        else:
            want = torch.argmax(logits, -1).to(torch.int32)
        assert torch.equal(got, want)
        _same_pool(eng.caches, ref)
        tok = got[:, None].clone()
    assert eng.graph.eager_calls == 3 and eng.graph.replays == 0
    assert _ptrs(eng) == ptrs


@pytest.mark.parametrize("kw", [dict(kv_cache="int8"),
                                dict(kv_cache="int8", kv_block_size=8, temperature=0.8, seed=3)],
                         ids=["int8", "int8-paged-sampled"])
def test_wave_fn_equals_three_spec_waves(smoke, kw):
    """The wave function on its static buffers against make_spec_wave
    called on a copy of the pool, three waves in a row (the base lengths
    advancing by k + 1 each, as if every draft were accepted)."""
    api, params = smoke
    k = 3
    eng = _engine(api, params, spec_k=k, **kw)
    ref = _clone(eng.caches)
    ptrs = _ptrs(eng)
    wave = make_spec_wave(eng.api, k=k, temperature=eng.temperature,
                          seed_key=sampling.prng_key(3))
    tok = torch.from_numpy(eng.next_tok.copy())
    rids = torch.tensor([r.rid if r else 0 for r in eng.slots], dtype=torch.int32)
    base = torch.tensor([len(r.prompt) + len(r.out) - 1 if r else 0 for r in eng.slots],
                        dtype=torch.int32)
    steps = torch.tensor([len(r.out) if r else 0 for r in eng.slots], dtype=torch.int32)
    for _ in range(3):
        eng._fill(tok=tok.numpy(), rids=rids.numpy(), steps=steps.numpy(),
                  base_lens=base.numpy())
        toks, cand = eng._step_fn()
        want_toks, want_cand, ref = wave(params, eng.draft_params, ref, tok, rids, steps, base)
        assert torch.equal(toks, want_toks) and torch.equal(cand, want_cand)
        _same_pool(eng.caches, ref)
        assert all(c["len"].tolist() == (base + k + 1).tolist() for c in eng.caches)
        tok, base, steps = cand[:, -1:].clone(), base + k + 1, steps + k + 1
    assert eng.graph.eager_calls == 3
    assert _ptrs(eng) == ptrs


def test_engine_steps_keep_every_leaf(smoke):
    """A whole run, admissions and evictions included, rebinds no cache
    leaf: what a graph captured stays what the engine holds."""
    api, params = smoke
    for kw in (dict(kv_cache="int8", kv_block_size=8, prefix_cache=True, spec_k=2),
               dict(kv_cache="binary")):
        eng = ServeEngine(api, params, max_batch=2, max_len=48, **kw)
        ptrs = _ptrs(eng)
        rng = np.random.default_rng(4)
        for n in (5, 9, 13, 6):
            eng.add_request(rng.integers(0, api.cfg.vocab, n), max_new=6)
        eng.run()
        assert _ptrs(eng) == ptrs
        assert eng.graph.eager_calls == eng.stats["decode_steps"] > 0


def test_eager_engine_equals_step_graph_engine(smoke):
    """cuda_graphs=False (every step called directly) and the StepGraph's
    CPU path give the same tokens."""
    api, params = smoke
    outs = []
    for graphs in (True, False):
        eng = ServeEngine(api, params, max_batch=2, max_len=48, kv_cache="int8", spec_k=2,
                          cuda_graphs=graphs)
        rng = np.random.default_rng(5)
        rids = [eng.add_request(rng.integers(0, api.cfg.vocab, n), max_new=7) for n in (4, 8, 3)]
        res = eng.run()
        outs.append([res[r] for r in rids])
        assert (eng.graph is None) == (not graphs)
    assert outs[0] == outs[1]
