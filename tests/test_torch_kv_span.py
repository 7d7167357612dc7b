"""The speculative verify's cache writes and attends in the port, against
repro.

* ``insert_span`` on the contiguous pool against repro's ``_write_span``
  (the "dus" path a single device takes: the start clamped to T - S), and
  ``paged_insert_span`` against repro's, every codec: the codes exactly
  (the port's spare block left out: repro drops those writes), ``len``
  advanced by S. The spans cross a page, reach T, and meet a hole and a
  free slot.
* The per-query-length attends (``q_lens``) of both pools against repro's
  ``_fused_quant_decode`` and ``paged_decode_attention`` within 1e-5 (f32;
  the two packages sum in other orders).
* A CPU mirror of the insert kernel's row -> (block, offset) map
  (``dst_row`` in csrc/kv_quant.cu) lands every span row where the plain
  version writes it.
* kv_decode's chunking of G * S query rows above ``MAX_ROWS``: the chunks
  cover S with at most MAX_ROWS rows each, and attending chunk by chunk
  gives the whole call's rows.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import kvcache as jkvc  # noqa: E402
from repro_torch.kernels import kv_decode as kvd  # noqa: E402
from repro_torch.kernels import kv_quant as kvq  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402

torch.set_num_threads(2)

CODECS = ("bf16", "int8", "binary")
H, D, S = 2, 16, 4
T = 16                          # contiguous time extent
BS, N_PAGES, N_BLOCKS = 4, 4, 12


def _torch(a) -> torch.Tensor:
    """A repro leaf as the port holds it (uint32 words as int32 bit views,
    bf16 bit for bit)."""
    a = np.array(a)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _contiguous(name, lens):
    """repro's contiguous layer and the port's copy of it: random K/V over
    all T positions (f32, so the bf16 codec stores f32), lengths ``lens``."""
    jc = jkvc.get_codec(name)
    b = len(lens)
    jcache = jc.from_prefill(jnp.asarray(_rand((b, T, H, D), 0)),
                             jnp.asarray(_rand((b, T, H, D), 1)), T)
    jcache["len"] = jnp.asarray(lens, jnp.int32)
    return jcache, {n: _torch(a) for n, a in jcache.items()}


# the span lengths: within T, clamped at T - S (len 14), the last
# position, and a free slot (0)
CONTIG_LENS = [3, 14, 15, 0]


@pytest.mark.parametrize("name", CODECS)
def test_insert_span_equals_repro_write_span(name):
    jcache, cache = _contiguous(name, CONTIG_LENS)
    kn, vn = _rand((4, S, H, D), 2), _rand((4, S, H, D), 3)
    kn[1, 2] = 0.0
    want = jkvc.get_codec(name).insert_span(jcache, jnp.asarray(kn), jnp.asarray(vn),
                                            method="dus")
    ptr = cache["len"].data_ptr()
    got = kvc.get_codec(name).insert_span(cache, torch.from_numpy(kn), torch.from_numpy(vn))
    assert got["len"].data_ptr() == ptr                 # written in place
    for n, a in want.items():
        assert torch.equal(got[n], _torch(a)), n
    assert got["len"].tolist() == [n + S for n in CONTIG_LENS]


def _paged(name, lens):
    """repro's paged layer and the port's copy (one spare block appended):
    shuffled blocks, slot 0 with 2 pages (its span crosses into page 2),
    slot 1 with every page (its span runs past the table), slot 2 with a
    hole at its third page, slot 3 free (all holes)."""
    jc = jkvc.get_codec(name)
    enc = jc.encode(jnp.asarray(_rand((N_BLOCKS, BS, H, D), 4)),
                    jnp.asarray(_rand((N_BLOCKS, BS, H, D), 5)))
    perm = list(np.random.default_rng(6).permutation(N_BLOCKS))
    table = np.full((4, N_PAGES), N_BLOCKS, np.int32)
    table[0, :3] = [perm.pop() for _ in range(3)]
    table[1, :] = [perm.pop() for _ in range(N_PAGES)]
    table[2, :2] = [perm.pop() for _ in range(2)]
    jcache = {**enc, "table": jnp.asarray(table), "len": jnp.asarray(lens, jnp.int32)}
    cache = {n: torch.cat([_torch(a), torch.zeros((1, *a.shape[1:]), dtype=_torch(a).dtype)])
             for n, a in enc.items()}
    cache["table"], cache["len"] = torch.from_numpy(table), torch.tensor(lens, dtype=torch.int32)
    return jcache, cache


PAGED_LENS = [6, 14, 7, 0]


@pytest.mark.parametrize("name", CODECS)
def test_paged_insert_span_equals_repro(name):
    jcache, cache = _paged(name, PAGED_LENS)
    kn, vn = _rand((4, S, H, D), 7), _rand((4, S, H, D), 8)
    codec, jcodec = kvc.get_codec(name), jkvc.get_codec(name)
    want = jkvc.paged_insert_span(jcache, jnp.asarray(kn), jnp.asarray(vn), jcodec)
    got = kvc.paged_insert_span(cache, torch.from_numpy(kn), torch.from_numpy(vn), codec)
    for n, a in want.items():
        mine = got[n] if n in ("table", "len") else got[n][:-1]
        assert torch.equal(mine, _torch(a)), n
    assert got["len"].tolist() == [n + S for n in PAGED_LENS]


def _q_lens(lens):
    return np.asarray(lens, np.int32)[:, None] + np.arange(1, S + 1, dtype=np.int32)[None]


@pytest.mark.parametrize("hq", [H, 2 * H])
@pytest.mark.parametrize("name", CODECS)
def test_q_lens_attends_equal_repro(name, hq):
    """The verify's attend after its span insert, every query below its own
    length, on both pools. On the paged pool the rows compared are those
    whose visible positions lie in allocated pages (as the engine's always
    do: it allocates spec_k pages of headroom): slots 0 and 1 and slot 2's
    first query. Past a hole repro reads the pool's last block and the port
    its spare block, both junk that no engine reads."""
    kn, vn = _rand((4, S, H, D), 9), _rand((4, S, H, D), 10)
    q = _rand((4, S, hq, D), 11)
    codec, jcodec = kvc.get_codec(name), jkvc.get_codec(name)
    for pool, lens in (("contiguous", [3, 11, 12, 0]), ("paged", PAGED_LENS)):
        jcache, cache = (_contiguous if pool == "contiguous" else _paged)(name, lens)
        ql = _q_lens(lens)
        if pool == "contiguous":
            jcache = jcodec.insert_span(jcache, jnp.asarray(kn), jnp.asarray(vn), method="dus")
            cache = codec.insert_span(cache, torch.from_numpy(kn), torch.from_numpy(vn))
            want = jkvc._fused_quant_decode(jnp.asarray(q), jcache, jcodec,
                                            q_lens=jnp.asarray(ql))
            got = codec.decode_attention(torch.from_numpy(q), cache,
                                         q_lens=torch.from_numpy(ql))
        else:
            jcache = jkvc.paged_insert_span(jcache, jnp.asarray(kn), jnp.asarray(vn), jcodec)
            cache = kvc.paged_insert_span(cache, torch.from_numpy(kn), torch.from_numpy(vn),
                                          codec)
            want = jkvc.paged_decode_attention(jnp.asarray(q), jcache, jcodec,
                                               q_lens=jnp.asarray(ql))
            got = kvc.paged_decode_attention(torch.from_numpy(q), cache, codec,
                                             q_lens=torch.from_numpy(ql))
        got, want = got.numpy(), np.asarray(want)
        if pool == "paged":
            got, want = (np.concatenate([a[:2].reshape(-1), a[2, :1].reshape(-1)])
                         for a in (got, want))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=pool)


def _dst_row(lens, table, b, s, h, *, t, n_pages, n_blocks):
    """csrc/kv_quant.cu's dst_row in lens mode, in Python: the leaf row
    (of (., t, H) rows) that span row (b, s, h) of the kernel writes."""
    ln = max(int(lens[b]), 0)
    if table is None:
        return (b * t + min(ln, t - S) + s) * H + h
    pos = ln + s
    page = pos // t
    phys = int(table[b, page]) if page < n_pages else n_blocks
    phys = min(max(phys, 0), n_blocks)
    return (phys * t + pos - page * t) * H + h


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("name", ["int8", "binary"])
def test_span_kernel_row_map_mirrors_plain(name, pool):
    """Every span row that the kernel's map sends into an addressed row
    (not the spare block, which takes several rows in no set order) holds
    that row's codes after the plain version's write."""
    if pool == "contiguous":
        _, cache = _contiguous(name, CONTIG_LENS)
        table, t, nb, lens = None, T, 0, CONTIG_LENS
    else:
        _, cache = _paged(name, PAGED_LENS)
        table, t, nb, lens = cache["table"], BS, N_BLOCKS, PAGED_LENS
    kn, vn = torch.from_numpy(_rand((4, S, H, D), 12)), torch.from_numpy(_rand((4, S, H, D), 13))
    names = kvq.leaf_names(name)
    enc = dict(zip(names, (*kvq.kv_quant_int8_plain(kn), *kvq.kv_quant_int8_plain(vn))
                   if name == "int8" else
                   (*kvq.kv_quant_binary_plain(kn), *kvq.kv_quant_binary_plain(vn))))
    new_lens = kvq.kv_insert(name, cache, kn, vn, cache["len"].clone(), table=table)
    assert new_lens.tolist() == [n + S for n in lens]
    seen = 0
    for b in range(4):
        for s in range(S):
            for h in range(H):
                row = _dst_row(lens, table, b, s, h, t=t, n_pages=N_PAGES, n_blocks=nb)
                if table is not None and row // (t * H) == nb:
                    continue
                seen += 1
                for n in names:
                    flat = cache[n].reshape(-1, *cache[n].shape[3:])
                    assert torch.equal(flat[row], enc[n][b, s, h]), (n, b, s, h)
    # paged: slot 0 all 4, slot 1 the 2 below the table, slot 2 the 1 before
    # its hole, the free slot none
    assert seen == (4 * S * H if table is None else 7 * H)


@pytest.mark.parametrize("g,s", [(1, 4), (1, 9), (4, 3), (8, 2), (2, 8)])
def test_query_chunks_cover_s_within_max_rows(g, s):
    chunks = kvd.query_chunks(s, g)
    assert chunks[0][0] == 0 and chunks[-1][1] == s
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < (s1 - s0) * g <= kvd.MAX_ROWS for s0, s1 in chunks)
    assert len(chunks) == -(-g * s // (kvd.MAX_ROWS // g * g))
    assert len(kvd.query_chunks(4, 1)) == 1         # stablelm-3b at k = 3: one launch


def test_chunked_attend_equals_whole():
    """Query chunks attend as the whole call does: each query row of the
    recurrence is its own."""
    name = "int8"
    lens = [3, 11, 12, 0]
    _, cache = _contiguous(name, lens)
    s, g = 9, 2
    q = torch.from_numpy(_rand((4, s, g * H, D), 14))
    ql = torch.from_numpy(np.asarray(lens, np.int32)[:, None]
                          + np.arange(1, s + 1, dtype=np.int32)[None])
    codec = kvc.get_codec(name)
    whole = codec.decode_attention(q, cache, q_lens=ql)
    parts = [codec.decode_attention(q[:, a:b].contiguous(), cache,
                                    q_lens=ql[:, a:b].contiguous())
             for a, b in kvd.query_chunks(s, g)]
    assert len(parts) == 3
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, rtol=1e-6, atol=1e-6)
