"""The insert kernel's plain version against repro's pool writes, exactly.

``kernels/kv_quant.py``'s ``kv_insert`` and ``kv_prefill`` encode K and V
and write codes and scales into the pool in one launch on the card; for a
CPU tensor they run their plain version (the encode pair, then the pool's
torch scatter), which the card holds the kernel to bit for bit. Here the
port's codec entry points, which reach those wrappers, are held against
repro's, leaf for leaf:

* (b) ``Int8Codec`` / ``BinaryCodec.insert_span`` of one token (a decode
  step's insert) on a contiguous pool at lengths 0, 1, T - 1 and T
  (repro's insert_timestep: dynamic_update_slice clamps T to T - 1);
* (c) ``paged_insert_span`` of one token on a paged pool with a shuffled table,
  holes, a free slot (all holes) and a length of n_pages * bs (no page):
  repro drops those writes, the port lands them in its spare block, so the
  addressed blocks must match and the spare block must have been written;
* (d) ``from_prefill``: zero codes and zero scales past S.

Each for int8 and binary, bf16 and f32 K/V, and D 16, 80 (stablelm-3b's)
and 129 (a ragged last word). Inputs come from numpy with a seed. The last
test mirrors in torch the order in which the kernel's 16-lane groups sum
mean |x| and build the sign words, and holds it to ``_lane_sum`` and
``pack_bits``.
"""

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.serving import kvcache as jkvc  # noqa: E402
from repro_torch.core.binarize import pack_bits  # noqa: E402
from repro_torch.kernels import kv_quant as kvq  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402

torch.set_num_threads(2)

CODECS = ("int8", "binary")
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}
DIMS = (16, 80, 129)
H = 2
LENS = [0, 1, 7, 8]          # T = 8: empty, one token, the last position, full (clamped)


def _t(a) -> torch.Tensor:
    """A numpy / jax array as a torch tensor with the same bits."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32))
    return torch.from_numpy(a)


def _same(got: torch.Tensor, want) -> None:
    want = _t(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want), int((got != want).sum())


def _kv(rng, shape, dtype):
    """(jax, torch) copies of seeded k and v, with one all-zero row in k."""
    k, v = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    k.reshape(-1, shape[-1])[0] = 0.0
    k, v = k.astype(DTYPES[dtype][0]), v.astype(DTYPES[dtype][0])
    return (jnp.asarray(k), jnp.asarray(v)), (_t(k), _t(v))


def _random_leaves(rng, codec, nb, t, d):
    """Random codes and scales (numpy) for a pool of nb x t rows of H heads,
    so untouched rows are told apart from written ones."""
    width = d if codec == "int8" else -(-d // 32)

    def codes():
        if codec == "int8":
            return rng.integers(-127, 128, (nb, t, H, width), dtype=np.int8)
        return rng.integers(0, 2 ** 32, (nb, t, H, width), dtype=np.uint32)

    def scales():
        return rng.random((nb, t, H), dtype=np.float32).astype(ml_dtypes.bfloat16)
    return dict(zip(kvq.leaf_names(codec), (codes(), scales(), codes(), scales())))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("codec", CODECS)
def test_contiguous_insert_equals_repro(codec, dtype, d):
    rng = np.random.default_rng(d)
    leaves = _random_leaves(rng, codec, len(LENS), 8, d)
    lens = np.asarray(LENS, np.int32)
    (jk, jv), (tk, tv) = _kv(rng, (len(LENS), 1, H, d), dtype)
    jcache = {**{n: jnp.asarray(a) for n, a in leaves.items()}, "len": jnp.asarray(lens)}
    cache = {**{n: _t(a) for n, a in leaves.items()}, "len": torch.from_numpy(lens)}
    want = jkvc.get_codec(codec).insert_timestep(jcache, jk, jv)
    got = kvc.get_codec(codec).insert_span(cache, tk, tv)
    assert set(got) == set(want)
    for name in want:
        _same(got[name], want[name])
    assert got["len"].tolist() == [n + 1 for n in LENS]


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("codec", CODECS)
def test_paged_insert_equals_repro(codec, dtype, d):
    rng = np.random.default_rng(100 + d)
    bs, n_pages, n_blocks = 4, 2, 9
    leaves = _random_leaves(rng, codec, n_blocks, bs, d)
    # slots: lens 0, 1, 7 (page 1), 8 = n_pages * bs (no page), and a free
    # slot; shuffled blocks, holes (ids >= n_blocks) past each slot's pages
    lens = np.asarray(LENS + [0], np.int32)
    perm = rng.permutation(n_blocks).astype(np.int32)
    table = np.asarray([[perm[0], n_blocks], [perm[1], n_blocks + 3], [perm[2], perm[3]],
                        [perm[4], perm[5]], [n_blocks, n_blocks + 1]], np.int32)
    (jk, jv), (tk, tv) = _kv(rng, (len(lens), 1, H, d), dtype)
    jcache = {**{n: jnp.asarray(a) for n, a in leaves.items()},
              "table": jnp.asarray(table), "len": jnp.asarray(lens)}
    # the port's pool holds one spare block past the n_blocks the table addresses
    cache = {**{n: torch.cat([_t(a), torch.zeros_like(_t(a)[:1])]) for n, a in leaves.items()},
             "table": torch.from_numpy(table), "len": torch.from_numpy(lens.copy())}
    codec_j, codec_t = jkvc.get_codec(codec), kvc.get_codec(codec)
    want = jkvc.paged_insert_timestep(jcache, jk, jv, codec_j)
    got = kvc.paged_insert_span(cache, tk, tv, codec_t)
    for name in kvq.leaf_names(codec):
        _same(got[name][:-1], want[name])
    # the free slot and the slot past its pages wrote the spare block's row 0
    assert bool(got["k_s"][-1, 0].view(torch.int16).any())
    assert not bool(got["k_s"][-1, 1:].view(torch.int16).any())
    assert got["len"].tolist() == np.asarray(want["len"]).tolist() == [n + 1 for n in lens]
    assert torch.equal(got["table"], torch.from_numpy(table))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("codec", CODECS)
def test_from_prefill_equals_repro(codec, dtype, d):
    rng = np.random.default_rng(200 + d)
    (jk, jv), (tk, tv) = _kv(rng, (2, 5, H, d), dtype)
    want = jkvc.get_codec(codec).from_prefill(jk, jv, 8)
    got = kvc.get_codec(codec).from_prefill(tk, tv, 8)
    assert set(got) == set(want)
    for name in want:
        _same(got[name], want[name])
    for name in kvq.leaf_names(codec):
        assert not bool(got[name][:, 5:].view(torch.int16 if name.endswith("_s")
                                              else got[name].dtype).any())


def test_wrappers_refuse_other_codecs_and_count_no_launch_on_cpu():
    k = torch.randn(2, 1, H, 16)
    cache = kvc.get_codec("int8").init(2, 4, H, 16, device="cpu")
    before = (kvq.kv_quant_int8.launches, kvq.kv_quant_binary.launches)
    cache["len"] = kvq.kv_insert("int8", cache, k, k, cache["len"])
    kvq.kv_prefill("binary", k, k, 4)
    assert (kvq.kv_quant_int8.launches, kvq.kv_quant_binary.launches) == before
    assert cache["len"].tolist() == [1, 1]
    with pytest.raises(ValueError, match="int8 or binary"):
        kvq.kv_insert("bf16", cache, k, k, cache["len"])
    with pytest.raises(ValueError, match="int8 or binary"):
        kvq.kv_prefill("bf16", k, k, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        kvq.kv_insert("int8", cache, k.to("meta"), k.to("meta"), cache["len"])


def _kernel_order(a: torch.Tensor):
    """The kernel's B4c row work in torch: lane j (of a 16-lane group) sums
    |x[32 w + j]| and |x[32 w + 16 + j]| over the words w in order (virtual
    lanes j and j + 16), adds the two, then takes xor steps at 8, 4, 2, 1,
    own value first; lane 0 stores. Word w's low 16 bits come from the
    first reads (bit j), its high 16 from the second. -> (sum, words)."""
    r, d = a.shape
    kp = -(-d // 32)
    x = torch.cat([a, a.new_zeros((r, kp * 32 - d))], dim=1).reshape(r, kp, 2, 16)
    valid = (torch.arange(kp * 32) < d).reshape(kp, 2, 16)
    acc = a.new_zeros((r, 2, 16))
    for w in range(kp):
        acc = torch.where(valid[w], acc + x[:, w].abs(), acc)
    s = acc[:, 0] + acc[:, 1]
    lane = torch.arange(16)
    for off in (8, 4, 2, 1):
        s = s + s[:, lane ^ off]
    bits = (x >= 0) | ~valid
    shifts = torch.arange(16, dtype=torch.int64)
    half = (bits.to(torch.int64) << shifts).sum(-1)              # (r, kp, 2)
    words = half[..., 0] | (half[..., 1] << 16)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    return s[:, 0], words


@pytest.mark.parametrize("d", [16, 80, 96, 129, 256])
def test_kernel_lane_order_mirror_equals_lane_sum(d):
    """The mirror of the kernel's 16-lane order gives _lane_sum's bits and
    pack_bits' words; its vector mapping (lane j, register k -> element)
    covers each element below D once for 8-, 4- and 1-element loads."""
    rng = np.random.default_rng(d)
    a = torch.from_numpy((rng.standard_normal((64, d)) *
                          np.exp(rng.standard_normal((64, 1)) * 4)).astype(np.float32))
    a[3] = 0.0
    s, words = _kernel_order(a)
    assert torch.equal(s.view(torch.int32), kvq._lane_sum(a.abs()).view(torch.int32))
    assert torch.equal(words, pack_bits(a))
    for ve in (8, 4, 1):
        if d % ve:
            continue
        got = sorted((j + 16 * (k // ve)) * ve + k % ve for j in range(16)
                     for k in range(kvq.MAX_D // 16)
                     if (j + 16 * (k // ve)) * ve + k % ve < d)
        assert got == list(range(d))
