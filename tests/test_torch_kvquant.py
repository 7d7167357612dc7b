"""The port's KV quantize / dequantize (B4a-d) against repro's, bit for bit.

The plain versions (``kernels/kv_quant.py``, which the CUDA kernels are held
to on the card) must equal repro's XLA twins and its Pallas kernels, run in
interpret mode as repro's own tests run them on the CPU: the same int8
values, the same packed words (uint32 there, int32 with the same bits here),
the same bf16 scales and the same dequantized values, in f32 and in bf16.
Inputs come from numpy with a seed, in f32 and bf16, at the shapes of
tests/test_kvcache.py plus stablelm-3b's head_dim 80, each with one
all-zero row (a zero scale divides by 1; its binary scale is 0).
"""

import functools

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import kv_quant as jkvq  # noqa: E402
from repro_torch.kernels import kv_quant as kvq  # noqa: E402

torch.set_num_threads(2)

# tests/test_kvcache.py's SHAPES, and (B, S, Hkv, D) with D = 80
SHAPES = [(2, 5, 3, 16), (4, 32, 2, 64), (1, 7, 1, 129), (2, 6, 4, 80)]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, jnp.bfloat16)}


def _inputs(shape, dtype: str, seed: int = 0):
    """(numpy, torch) copies of one seeded input with an all-zero row."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x.reshape(-1, shape[-1])[1] = 0.0
    x = x.astype(DTYPES[dtype][0])
    return x, _t(x)


def _t(a) -> torch.Tensor:
    """A numpy / jax array as a torch tensor with the same bits."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32))
    return torch.from_numpy(a)


def _same(got: torch.Tensor, want) -> None:
    """Bit-for-bit equality (bf16 compared through its int16 view)."""
    want = _t(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    assert torch.equal(got, want), int((got != want).sum())


@functools.partial(jax.jit, static_argnums=1)
def _repro_twins(x, d):
    """Every XLA twin on one input, in one compiled call (eager JAX would
    compile op by op, ~1 s per shape)."""
    q, s = jkvq.kv_quant_int8_xla(x)
    p, ps = jkvq.kv_quant_binary_xla(x)
    deq = {name: (jkvq.kv_dequant_int8_xla(q, s, out[2]),
                  jkvq.kv_dequant_binary_xla(p, ps, d, out[2]))
           for name, out in DTYPES.items()}
    return q, s, p, ps, deq


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_versions_equal_repro_xla_twins(shape, dtype):
    x, tx = _inputs(shape, dtype)
    d = shape[-1]
    q, s, p, ps, deq = _repro_twins(jnp.asarray(x), d)
    tq, ts = kvq.kv_quant_int8(tx)              # a CPU tensor: the plain version
    _same(tq, q)
    _same(ts, s)
    tp, tps = kvq.kv_quant_binary(tx)
    _same(tp, p)
    _same(tps, ps)
    assert not tps.view(torch.int16).reshape(-1)[1]       # the zero row's scale
    for name, out in DTYPES.items():
        _same(kvq.kv_dequant_int8(tq, ts, dtype=out[1]), deq[name][0])
        _same(kvq.kv_dequant_binary(tp, tps, d, dtype=out[1]), deq[name][1])


# one interpret-mode run of each Pallas kernel per shape, the dtypes taken
# in turn (interpret mode compiles per shape, and each takes ~0.5 s)
PALLAS_CASES = [(SHAPES[0], "float32"), (SHAPES[1], "bfloat16"),
                (SHAPES[2], "float32"), (SHAPES[3], "bfloat16")]


@pytest.mark.parametrize("shape,dtype", PALLAS_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_plain_versions_equal_repro_pallas_interpret(shape, dtype):
    x, tx = _inputs(shape, dtype, seed=1)
    jx, d = jnp.asarray(x), shape[-1]
    q, s = jkvq.kv_quant_int8_pallas(jx, interpret=True)
    tq, ts = kvq.kv_quant_int8_plain(tx)
    _same(tq, q)
    _same(ts, s)
    _same(kvq.kv_dequant_int8_plain(tq, ts, torch.float32),
          jkvq.kv_dequant_int8_pallas(q, s, dtype=jnp.float32, interpret=True))
    p, ps = jkvq.kv_quant_binary_pallas(jx, interpret=True)
    tp, tps = kvq.kv_quant_binary_plain(tx)
    _same(tp, p)
    _same(tps, ps)
    _same(kvq.kv_dequant_binary_plain(tp, tps, d, torch.bfloat16),
          jkvq.kv_dequant_binary_pallas(p, ps, d, dtype=jnp.bfloat16, interpret=True))


def test_binary_words_pad_bits_and_sign_of_zero():
    """D = 80 packs to 3 words; the last word's 16 pad bits are 1, and
    sign(0) is +1 (bit 1), as in core/binarize.pack_bits."""
    x = torch.full((1, 80), -1.0)
    x[0, 5] = 0.0
    words, scale = kvq.kv_quant_binary(x)
    assert words.shape == (1, 3) and words.dtype == torch.int32
    assert words[0, 0].item() == 1 << 5 and words[0, 1].item() == 0
    assert words[0, 2].item() == -(1 << 16)           # bits 16..31 set: 0xffff0000
    assert scale.item() == pytest.approx(79 / 80, rel=1e-2)


def test_wrappers_count_no_launch_on_cpu_and_refuse_other_devices():
    x = torch.randn(4, 16)
    before = [f.launches for f in (kvq.kv_quant_int8, kvq.kv_dequant_int8,
                                   kvq.kv_quant_binary, kvq.kv_dequant_binary)]
    q, s = kvq.kv_quant_int8(x)
    kvq.kv_dequant_int8(q, s)
    p, ps = kvq.kv_quant_binary(x)
    kvq.kv_dequant_binary(p, ps, 16)
    assert [f.launches for f in (kvq.kv_quant_int8, kvq.kv_dequant_int8,
                                 kvq.kv_quant_binary, kvq.kv_dequant_binary)] == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        kvq.kv_quant_int8(x.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        kvq.kv_dequant_binary(p.to("meta"), ps.to("meta"), 16)
