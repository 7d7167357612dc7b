"""The port's dequant-fused decode attention (``kernels/kv_decode.py``)
against repro's ``_fused_quant_decode`` and ``paged_decode_attention``.

* The plain versions, which the CUDA kernel is held to on the card, on the
  contiguous and the paged pool: both sides get the same numpy-made encoded
  leaves (int8 codes and bf16 scales; sign words as uint32 there and as
  int32 bit views here, pad bits set), f32 queries, G in {1, 4}, T in
  {32, 200} (200: a ragged last kv block of 128), lengths 1, T, one between
  and 0 (a free slot; both sides average over the columns they visit), and
  on the paged pool a shuffled table with holes past every length.
  Tolerance 1e-5: f32 throughout, and the two tile the sums differently on
  the paged pool (repro one page per step, the port 128 positions).
* The kernel's score arithmetic, mirrored in plain torch, equals
  q . dequant(k) within 1e-5 for D in {64, 80, 96, 128}: int8 takes the
  dot with the codes and then the scale; binary takes
  s (2 sum_{bit=1} q_i - sum q_i) over the first D bits, with the pad bits
  set and q zero past D.
* On the CPU the wrappers run the plain versions and count no launch; any
  device but cuda and cpu is refused.
"""

import functools

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.serving import kvcache as jkvc  # noqa: E402
from repro_torch.core.binarize import packed_len  # noqa: E402
from repro_torch.kernels import kv_decode as kvd  # noqa: E402
from repro_torch.kernels import kv_quant as kvq  # noqa: E402

torch.set_num_threads(2)

B, HKV, D, BLOCK = 4, 2, 80, 8


def _t(a) -> torch.Tensor:
    """A numpy array as a torch tensor with the same bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
    return torch.from_numpy(a.copy())


def _words(rng, shape, d):
    """uint32 sign words (.., ceil(d / 32)) with the pad bits set."""
    kp = packed_len(d)
    w = rng.integers(0, 2 ** 32, (*shape, kp), dtype=np.uint64).astype(np.uint32)
    if d % 32:
        w[..., -1] |= np.uint32((0xFFFFFFFF << (d % 32)) & 0xFFFFFFFF)
    return w


def _leaves(codec: str, rows: tuple, rng) -> dict:
    """Encoded K/V leaves over leading dims ``rows`` (.., Hkv)."""
    scales = {n: rng.uniform(0.005, 0.02 if codec == "int8" else 1.0, rows)
              .astype(ml_dtypes.bfloat16) for n in ("k_s", "v_s")}
    if codec == "int8":
        codes = {n: rng.integers(-127, 128, (*rows, D)).astype(np.int8) for n in ("k_q", "v_q")}
    else:
        codes = {n: _words(rng, rows, D) for n in ("k_p", "v_p")}
    return {**codes, **scales}


def _port_decode(codec, q, leaves, lens, table=None):
    tl = {n: _t(a) for n, a in leaves.items()}
    tq, tlens = torch.from_numpy(q), torch.from_numpy(lens)
    tt = None if table is None else torch.from_numpy(table)
    if codec == "int8":
        return kvd.kv_decode_int8_plain(tq, tl["k_q"], tl["k_s"], tl["v_q"], tl["v_s"], tlens,
                                        table=tt)
    return kvd.kv_decode_binary_plain(tq, tl["k_p"], tl["k_s"], tl["v_p"], tl["v_s"], tlens,
                                      D, table=tt)


@functools.lru_cache(maxsize=None)
def _repro_fn(codec: str, paged: bool):
    fn = jkvc.paged_decode_attention if paged else jkvc._fused_quant_decode
    return jax.jit(functools.partial(fn, codec=jkvc.get_codec(codec)))


@pytest.mark.parametrize("t", [32, 200])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("codec", ["int8", "binary"])
def test_plain_versions_match_repro(codec, pool, g, t):
    rng = np.random.default_rng(t + 7 * g)
    q = rng.standard_normal((B, 1, HKV * g, D)).astype(np.float32)
    lens = np.array([1, t, t // 2 + 3, 0], np.int32)
    if pool == "contiguous":
        leaves = _leaves(codec, (B, t, HKV), rng)
        table = None
        cache = {**leaves, "len": lens}
    else:
        n_pages = t // BLOCK
        used = [-(-n // BLOCK) for n in lens]
        n_blocks = sum(used) + 3                  # + blocks no slot holds
        leaves = _leaves(codec, (n_blocks, BLOCK, HKV), rng)
        perm = rng.permutation(n_blocks).astype(np.int32)
        table = np.full((B, n_pages), n_blocks + 5, np.int32)     # holes
        at = 0
        for i, u in enumerate(used):
            table[i, :u] = perm[at:at + u]
            at += u
        cache = {**leaves, "table": table, "len": lens}
    want = _repro_fn(codec, pool == "paged")(jnp.asarray(q),
                                             jax.tree.map(jnp.asarray, cache))
    got = _port_decode(codec, q, leaves, lens, table)
    assert got.shape == q.shape and got.dtype == torch.float32
    torch.testing.assert_close(got, torch.from_numpy(np.array(want)), atol=1e-5, rtol=1e-5)


def _kernel_scores(codec: str, q: torch.Tensor, codes: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """The kernel's score of one query row against one key row, before the
    softmax scale (csrc/kv_decode.cu): int8 the dot with the codes, then
    the key's scale; binary s (2 sum_{bit=1} q_i - sum_i q_i), the bits of
    every word summed against q zero-filled past D (pad bits count 0)."""
    s = scale.to(torch.float32)
    if codec == "int8":
        return (q * codes.to(torch.float32)).sum(-1) * s
    kp = codes.shape[-1]
    qpad = torch.cat([q, q.new_zeros((*q.shape[:-1], 32 * kp - q.shape[-1]))], -1)
    bits = torch.stack([(codes[..., i // 32] >> (i % 32)) & 1 for i in range(32 * kp)], -1)
    return s * (2.0 * (qpad * bits.to(torch.float32)).sum(-1) - q.sum(-1))


@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("codec", ["int8", "binary"])
def test_kernel_score_arithmetic_equals_q_dot_dequant(codec, d):
    rng = np.random.default_rng(d)
    n = 64
    q = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    scale = _t(rng.uniform(0.005, 0.02 if codec == "int8" else 1.0, n)
               .astype(ml_dtypes.bfloat16))
    if codec == "int8":
        codes = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(np.int8))
        k = kvq.kv_dequant_int8_plain(codes, scale, torch.float32)
    else:
        codes = _t(_words(rng, (n,), d))
        k = kvq.kv_dequant_binary_plain(codes, scale, d, torch.float32)
    want = (q * k).sum(-1)
    torch.testing.assert_close(_kernel_scores(codec, q, codes, scale), want,
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("codec", ["int8", "binary"])
def test_wrappers_on_cpu_run_the_plain_version(codec, paged):
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, 1, HKV, D)).astype(np.float32)
    lens = np.array([3, 16, 9, 0], np.int32)
    if paged:
        leaves = _leaves(codec, (9, BLOCK, HKV), rng)
        table = np.array([[0, 9], [1, 2], [3, 4], [9, 9]], np.int32)
    else:
        leaves = _leaves(codec, (B, 16, HKV), rng)
        table = None
    tl = [_t(leaves[n]) for n in (f"k_{'q' if codec == 'int8' else 'p'}", "k_s",
                                  f"v_{'q' if codec == 'int8' else 'p'}", "v_s")]
    tq, tlens = torch.from_numpy(q), torch.from_numpy(lens)
    tt = None if table is None else torch.from_numpy(table)
    wrapper = getattr(kvd, f"kv_decode_{codec}")
    extra = () if codec == "int8" else (D,)
    before = wrapper.launches
    got = wrapper(tq, *tl, tlens, *extra, table=tt)
    assert wrapper.launches == before
    assert torch.equal(got, _port_decode(codec, q, leaves, lens, table))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        wrapper(tq.to("meta"), *(x.to("meta") for x in tl), tlens.to("meta"), *extra)
