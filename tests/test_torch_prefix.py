"""The port's radix prefix cache over the paged pool, against repro.

* The pure-Python pool (``repro_torch/serving/prefix.py``, a copy of
  repro's): tests/test_prefix_cache.py's radix and allocator units, and
  tests/test_prefix_property.py's invariants under hypothesis (fewer
  examples: the copy's logic is repro's line for line).
* The engine: tests/test_prefix_cache.py's scenarios (shared header,
  partial overlap mid-block, refcounts surviving a sharer's eviction, int8
  and binary on the paged pool, eviction under pressure, a matched chain
  pinned before allocation) on the ``trained_lm`` fixture. Each must give
  repro's tokens — the greedy outputs of repro's uncached contiguous engine
  for the same prompts and codec, which repro's own tests hold its prefix
  engine to — and repro's prefix-hit counts; the shared-header scenario is
  also run through repro's own prefix-cached engine and compared stat for
  stat.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis", reason="optional dep: pip install hypothesis")

import jax  # noqa: E402
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.prefix import PrefixPool  # noqa: E402

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# radix tree and allocator (no model)
# ---------------------------------------------------------------------------

def test_match_is_block_aligned_and_capped():
    pool = PrefixPool(n_blocks=8, block_size=4)
    toks = np.arange(12)
    n0, owned = pool.publish(None, toks[:4], pool.alloc(1)[0])
    assert owned
    n1, _ = pool.publish(n0, toks[4:8], pool.alloc(1)[0])
    assert pool.match(np.arange(7)) == [n0]            # only full blocks match
    assert pool.match(np.arange(11)) == [n0, n1]
    assert pool.match(np.arange(8)) == [n0]            # >= 1 token must prefill
    assert pool.match(np.arange(4)) == []


def test_publish_dedup_keeps_duplicate_private():
    pool = PrefixPool(n_blocks=4, block_size=2)
    a, b = pool.alloc(2)
    n1, owned1 = pool.publish(None, [5, 6], a)
    n2, owned2 = pool.publish(None, [5, 6], b)
    assert owned1 and not owned2 and n1 is n2 and n1.ref == 2


def test_refcount_blocks_eviction_lru_frees_leaves():
    pool = PrefixPool(n_blocks=3, block_size=2)
    blocks = pool.alloc(3)
    n0, _ = pool.publish(None, [1, 2], blocks[0], clock=0)
    n1, _ = pool.publish(n0, [3, 4], blocks[1], clock=1)
    na, _ = pool.publish(None, [9, 9], blocks[2], clock=2)
    assert pool.alloc(1) is None                       # everything referenced
    pool.release([n0, n1])
    assert sorted(pool.alloc(2)) == sorted(blocks[:2])
    assert pool.stats["evicted_blocks"] == 2
    assert pool.match([1, 2, 3]) == [] and na.ref == 1


def test_release_underflow_asserts():
    pool = PrefixPool(n_blocks=2, block_size=2)
    n, _ = pool.publish(None, [1, 2], pool.alloc(1)[0])
    pool.release([n])
    with pytest.raises(AssertionError):
        pool.release([n])


# tests/test_prefix_property.py's invariants, on the port's copy
SET = dict(max_examples=20, deadline=None, derandomize=True)
N_BLOCKS, BS = 8, 4
OPS = st.lists(st.tuples(st.sampled_from(["alloc", "free", "publish", "acquire",
                                          "release", "match"]),
                         st.integers(0, 63), st.integers(0, 63)),
               min_size=1, max_size=80)


def _chain_tokens(seed, depth):
    return tuple((seed * 97 + depth * BS + j) % 251 for j in range(BS))


def _attached(node) -> bool:
    return node.parent.children.get(node.tokens) is node


def _check_invariants(pool, private, held):
    tree = {n.block for n in pool._walk()}
    free, priv = set(pool.free), set(private)
    assert len(free) == len(pool.free) and len(priv) == len(private)
    assert not (free & tree or free & priv or priv & tree)
    assert free | tree | priv == set(range(N_BLOCKS))
    for node, count in held.items():
        assert node.ref == count and (count == 0 or _attached(node))
    for node in pool._walk():
        assert node.ref == held.get(node, 0)


def _check_match(pool, tokens):
    got = [t for n in pool.match(tokens) for t in n.tokens]
    assert len(got) % BS == 0 and len(got) < len(tokens)
    assert got == [int(t) for t in tokens[:len(got)]]


@given(OPS)
@settings(**SET)
def test_pool_invariants_under_random_interleavings(ops):
    pool = PrefixPool(N_BLOCKS, BS)
    private, held, chains, clock = [], {}, {}, 0
    for kind, a, b in ops:
        clock += 1
        if kind == "alloc":
            private.extend(pool.alloc(a % 3 + 1, clock=clock) or [])
        elif kind == "free" and private:
            pool.free_blocks([private.pop(a % len(private))])
        elif kind == "publish" and private:
            chain = chains.setdefault(a % 4, [])
            if not all(_attached(n) for n in chain):
                chain = chains[a % 4] = []       # evicted: start again at the root
            if len(chain) < 4:
                block = private[b % len(private)]
                node, owned = pool.publish(chain[-1] if chain else None,
                                           _chain_tokens(a % 4, len(chain)), block,
                                           clock=clock)
                if owned:
                    private.remove(block)
                held[node] = held.get(node, 0) + 1
                chain.append(node)
        elif kind == "acquire" and chains:
            chain = chains[sorted(chains)[a % len(chains)]]
            take = chain[:b % len(chain) + 1] if chain else []
            if take and all(_attached(n) for n in take):
                pool.acquire(take)
                for n in take:
                    held[n] = held.get(n, 0) + 1
        elif kind == "release":
            pinned = [n for n, c in held.items() if c > 0]
            if pinned:
                n = pinned[a % len(pinned)]
                pool.release([n])
                held[n] -= 1
        elif kind == "match" and chains:
            seed = sorted(chains)[a % len(chains)]
            _check_match(pool, np.asarray(
                [t for d in range(b % 4 + 1) for t in _chain_tokens(seed, d)] + [7]))
        _check_invariants(pool, private, held)
    for n, c in held.items():
        for _ in range(c):
            pool.release([n])
    assert all(n.ref == 0 for n in pool._walk())
    assert pool.alloc(N_BLOCKS - len(set(private))) is not None


@given(st.integers(0, 3), st.integers(1, 17))
@settings(**SET)
def test_match_is_always_block_aligned_prefix(seed, qlen):
    pool = PrefixPool(N_BLOCKS, BS)
    blocks = pool.alloc(3)
    parent = None
    for d in range(3):
        parent, _ = pool.publish(parent, _chain_tokens(0, d), blocks[d])
    query = ([t for d in range(3) for t in _chain_tokens(0, d)] if seed == 0
             else list(_chain_tokens(seed, 0)) * 3)
    _check_match(pool, np.asarray(query[:qlen], np.int32))


@given(st.integers(1, 8))
@settings(**SET)
def test_release_underflow_always_asserts(extra):
    pool = PrefixPool(2, BS)
    node, _ = pool.publish(None, _chain_tokens(0, 0), pool.alloc(1)[0])
    pool.release([node])
    with pytest.raises(AssertionError):
        for _ in range(extra):
            pool.release([node])


# ---------------------------------------------------------------------------
# the engine, against repro, on the trained smoke LM
# ---------------------------------------------------------------------------

MAX_NEW = 18          # the most any scenario asks; shorter runs are prefixes


def _markov(start, n, vocab):
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return np.asarray(out, np.int32)


def _prompts(vocab):
    """tests/test_prefix_cache.py's prompts, by scenario."""
    def m(start, n):
        return _markov(start, n, vocab)

    def cat(*parts):
        return np.concatenate(parts)
    return {
        "shared": [cat(m(3, 24), m(50 + i, 6)) for i in range(5)],
        "partial": [cat(m(5, 21), m(80 + i, 7)) for i in range(3)],
        "refcount": [cat(m(7, 16), m(90, 4)), cat(m(7, 16), m(91, 5))],
        "codec": [cat(m(11, 16), m(60 + i, 6)) for i in range(4)],
        "pressure": [cat(m(30 + h, 16), m(70 + 10 * h + i, 5))
                     for h in range(3) for i in range(2)],
        "pinned": [cat(m(13, 16), m(94, 5)), m(96, 12), cat(m(13, 16), m(95, 15))],
    }


@pytest.fixture(scope="module")
def lm(trained_lm):
    """The port's copy of the trained LM, the prompts, and repro's tokens:
    one uncached contiguous repro engine per codec serves every prompt."""
    _, japi, jparams = trained_lm
    cfg = smoke_config("stablelm-3b").replace(
        policy=PrecisionPolicy(), compute_dtype="float32", param_dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    prompts = _prompts(cfg.vocab)
    repro = {}
    for codec, names in (("bf16", ("shared", "partial", "refcount", "pressure", "pinned")),
                         ("int8", ("codec",)), ("binary", ("codec",))):
        eng = JaxEngine(japi, jparams, max_batch=4, max_len=64, kv_cache=codec)
        todo = {p.tobytes(): p for n in names for p in prompts[n]}
        rids = {key: eng.add_request(p, max_new=MAX_NEW) for key, p in todo.items()}
        res = eng.run()
        repro[codec] = {key: res[r] for key, r in rids.items()}
    return get_model(cfg), params, prompts, repro


def _want(lm, codec, prompts, max_new=6):
    return [lm[3][codec][p.tobytes()][:max_new] for p in prompts]


def _serve(api, params, prompts, *, max_new=6, **kw):
    """The first request runs to the end before the rest arrive, so its
    published blocks are there to match (a wave's requests prefill
    independently)."""
    eng = ServeEngine(api, params, max_batch=2, max_len=64, **kw)
    rids = [eng.add_request(prompts[0], max_new=max_new)]
    eng.run()
    rids += [eng.add_request(p, max_new=max_new) for p in prompts[1:]]
    res = eng.run()
    return [res[r] for r in rids], eng


def test_shared_header_matches_repro_prefix_engine(lm, trained_lm):
    """Same tokens and the same hit counts as repro's own prefix-cached
    engine: 4 later arrivals x 24 header tokens (3 blocks of 8) from cache."""
    api, params, prompts, _ = lm
    got, eng = _serve(api, params, prompts["shared"], kv_block_size=8, prefix_cache=True)
    assert got == _want(lm, "bf16", prompts["shared"])
    _, japi, jparams = trained_lm
    jeng = JaxEngine(japi, jparams, max_batch=2, max_len=64, kv_block_size=8,
                     prefix_cache=True)
    rids = [jeng.add_request(prompts["shared"][0], max_new=6)]
    jeng.run()
    rids += [jeng.add_request(p, max_new=6) for p in prompts["shared"][1:]]
    res = jeng.run()
    assert got == [res[r] for r in rids]
    assert eng.stats["cached_prompt_tokens"] == jeng.stats["cached_prompt_tokens"] == 4 * 24
    assert eng.pool.stats == jeng.pool.stats and eng.pool.stats["hits"] == 4
    for key in ("prefills", "prefilled_tokens", "decode_steps", "generated_tokens",
                "kv_bytes"):
        assert eng.stats[key] == jeng.stats[key], key


def test_partial_overlap_mid_block(lm):
    """Prompts that part mid-block share only the 2 full blocks before it."""
    api, params, prompts, _ = lm
    got, eng = _serve(api, params, prompts["partial"], kv_block_size=8, prefix_cache=True)
    assert got == _want(lm, "bf16", prompts["partial"])
    assert eng.stats["cached_prompt_tokens"] == 2 * 16


def test_refcounted_blocks_survive_sharer_eviction(lm):
    api, params, prompts, _ = lm
    a, b = prompts["refcount"]
    eng = ServeEngine(api, params, max_batch=2, max_len=64, kv_block_size=8,
                      prefix_cache=True)
    ra = eng.add_request(a, max_new=2)          # publishes the header...
    eng.run()
    rb = eng.add_request(b, max_new=12)         # ...then b shares it
    eng.step()
    assert any(n.ref > 0 for n in eng.pool._walk())
    res = eng.run()
    assert [res[ra], res[rb]] == [_want(lm, "bf16", [a], 2)[0], _want(lm, "bf16", [b], 12)[0]]
    assert all(n.ref == 0 for n in eng.pool._walk())
    assert eng.pool.tree_blocks() + len(eng.pool.free) == eng.n_blocks


def test_int8_codec_on_paged_pool(lm):
    api, params, prompts, _ = lm
    got, eng = _serve(api, params, prompts["codec"], kv_cache="int8", kv_block_size=8,
                      prefix_cache=True)
    assert got == _want(lm, "int8", prompts["codec"])
    assert eng.stats["cached_prompt_tokens"] == 3 * 16


def test_binary_codec_on_paged_pool(lm):
    """Binary is the lossy codec: the paged pool without the prefix cache
    gives the contiguous binary engine's tokens; with it, requests hit and
    the cache-cold first request still matches (tests/test_prefix_cache.py)."""
    api, params, prompts, _ = lm
    want = _want(lm, "binary", prompts["codec"])
    got, _ = _serve(api, params, prompts["codec"], kv_cache="binary", kv_block_size=8)
    assert got == want
    pre, eng = _serve(api, params, prompts["codec"], kv_cache="binary", kv_block_size=8,
                      prefix_cache=True)
    assert eng.stats["cached_prompt_tokens"] == 3 * 16
    assert pre[0] == want[0] and [len(o) for o in pre] == [len(o) for o in want]


def test_eviction_under_pressure_stays_correct(lm):
    """n_blocks = the active working set (2 slots x 4 pages): published
    chains must be evicted to admit, and outputs do not move."""
    api, params, prompts, _ = lm
    got, eng = _serve(api, params, prompts["pressure"], kv_block_size=8, prefix_cache=True,
                      n_blocks=8)
    assert got == _want(lm, "bf16", prompts["pressure"])
    assert eng.pool.stats["evicted_blocks"] > 0


def test_matched_chain_pinned_before_allocation(lm):
    """Only B's own matched (refcount-0) header chain is evictable while A
    decodes: B defers rather than evict it, no slot holds a block twice,
    and B decodes exactly."""
    api, params, prompts, _ = lm
    header_req, a, b = prompts["pinned"]
    eng = ServeEngine(api, params, max_batch=2, max_len=64, kv_block_size=8,
                      prefix_cache=True, n_blocks=8)
    eng.add_request(header_req, max_new=2)
    eng.run()
    ra = eng.add_request(a, max_new=18)
    eng.step()
    rb = eng.add_request(b, max_new=8)
    eng.step()
    for stt in eng._pstate.values():
        real = [int(x) for x in stt.row if x < eng.n_blocks]
        assert len(real) == len(set(real))
        assert all(n.parent.children.get(n.tokens) is n for n in stt.chain)
    res = eng.run()
    assert res[rb] == _want(lm, "bf16", [b], 8)[0]
    assert res[ra] == _want(lm, "bf16", [a], 18)[0]
