"""The CUDA kernels on the card, against their plain torch versions.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (the kernels have no CPU mode). The file imports no jax and nothing of
``repro``, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the KV quantize / dequantize kernels are bit-exact (the same
IEEE operations in the same order as their plain versions, the mean's sum
included); the int8 and XNOR GEMMs are exact (integer dots of +-1
vectors), and so is the fused hybrid dense (both round the product and the
sum once each, then take the sign); the bf16 GEMM matches its plain version
within tests/test_kernels.py's 2e-2 (f32 sums in another order). Flash
attention matches the plain version within tests/test_attention.py's TOLS:
2e-5 in f32 (the online softmax sums in another order) and 3e-2 in bf16
(the kernel also rounds p to bf16 before p @ v, as the TPU kernel does).
The model checks run f32 on both devices; their only differences come
before sign() and are ~1e-6, so 1e-4 holds unless a value sits that close
to 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import hybrid_mlp as H  # noqa: E402
from repro_torch.core.binarize import pack_bits, pack_signs_int8  # noqa: E402
from repro_torch.kernels import COUNTED as GRAPH_COUNTED, ops  # noqa: E402
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain  # noqa: E402
from repro_torch.kernels.binary_matmul import (binary_matmul,  # noqa: E402
                                               binary_matmul_plain)
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.hybrid_dense import hybrid_dense, hybrid_dense_plain  # noqa: E402
from repro_torch.kernels.int8_matmul import (int8_matmul,  # noqa: E402
                                             int8_matmul_plain)
from repro_torch.kernels.ksplit import splits_for  # noqa: E402
from repro_torch.kernels import kv_decode as kvd  # noqa: E402
from repro_torch.kernels import kv_quant as kvq  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

TOLS = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


# (M, K, N): tiles that divide, ragged M / N / K tails, and the serving
# path's decode and prefill shapes (bin_out's K = 6912 is 13.5 x 512);
# then the edges of the two designs: M = 15, 16 (decode, one m16 tile) and
# 17, 129 (prefill, either side of its 128-row tile), N not a multiple of
# the 64- or 128-column tile, K = 32 and 96 (one stage, ragged), K = 6784
# (53 stages, which the 8-way K split leaves ragged) and K = 6944 (packed
# rows not 16-byte aligned: 4-byte loads, split), and the largest prefill
# bucket, M = 2048 at bin_out's (N, K) = (2560, 6912)
INT8_SHAPES = [(128, 256, 128), (256, 1024, 512), (5, 96, 40), (1, 32, 1),
               (77, 160, 130), (8, 2560, 6912), (8, 6912, 2560), (300, 6912, 2560),
               (15, 2560, 6912), (16, 6912, 2560), (17, 2560, 6912), (129, 2560, 200),
               (16, 32, 72), (3, 96, 2560), (8, 6784, 100), (8, 6944, 130),
               (40, 6944, 72), (2048, 6912, 2560)]


@pytest.mark.parametrize("m,k,n", INT8_SHAPES)
def test_int8_kernel_exact(dev, m, k, n):
    g = _gen(dev, m + k + n)
    a = pack_signs_int8(torch.randn(m, k, generator=g, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    before = int8_matmul.launches
    got = int8_matmul(a, pw)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert torch.equal(got, int8_matmul_plain(a, pw))


# (M, K, N): int8 activations over the whole range [-128, 127], not only
# +-1: the plain f32 version stays exact (|sum| <= 128 K < 2**24)
@pytest.mark.parametrize("m,k,n", [(8, 6912, 2560), (16, 2560, 6912), (300, 2560, 6912),
                                   (77, 160, 130)])
def test_int8_kernel_exact_full_int8_range(dev, m, k, n):
    g = _gen(dev, m + k + n + 1)
    a = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    got = int8_matmul(a, pw)
    torch.cuda.synchronize()
    assert torch.equal(got, int8_matmul_plain(a, pw))


def test_int8_kernel_refuses_unaligned_base(dev):
    a = torch.ones(8 * 64 + 4, dtype=torch.int8, device=dev)[4:].view(8, 64)
    pw = torch.zeros(16, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_matmul(a, pw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binary_dense_kernel_equals_cpu(dev, dtype):
    g = _gen(dev, 7)
    x = torch.randn(3, 5, 256, generator=g, device=dev).to(getattr(torch, dtype))
    w = pack_bits(torch.rand(256, 96, generator=g, device=dev).T * 2 - 1)
    got = ops.binary_dense_packed(x, w, mode="int8")
    want = ops.binary_dense_packed(x.cpu(), w.cpu(), mode="int8")
    assert torch.equal(got.cpu(), want)


# (M, K, N): the MNIST hidden layers at batch 1 / 128 / 512, K not a
# multiple of 32 (40, 100, 250), Kp = 12 (K = 384, which the TPU kernel
# refuses), ragged M and N, and the spec-draft shape (8, 2560, 6912); then
# M = 15 / 16 / 17 around the m16 tile (and the SMALL / MID switch), N = 8
# (one n8 tile) and N not a multiple of 8, Kp = 8 (K = 256, one k256 step)
# and Kp = 9 (4-byte copies, a second step of one word)
XNOR_SHAPES = [(1, 1024, 1024), (128, 1024, 1024), (512, 1024, 1024), (8, 40, 24),
               (32, 100, 48), (16, 250, 64), (64, 384, 64), (77, 160, 130),
               (8, 2560, 6912), (15, 1024, 1024), (16, 256, 8), (17, 288, 13),
               (130, 256, 77), (3, 270, 8)]


@pytest.mark.parametrize("m,k,n", XNOR_SHAPES)
def test_binary_matmul_kernel_exact(dev, m, k, n):
    g = _gen(dev, m + k + n)
    pa = pack_bits(torch.randn(m, k, generator=g, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    before = binary_matmul.launches
    got = binary_matmul(pa, pw, k)
    torch.cuda.synchronize()
    assert binary_matmul.launches == before + 1
    assert torch.equal(got, binary_matmul_plain(pa, pw, k))


# (M, K, N): a K range of 8 stages, so every split (1, 2, 4, 8 chunks)
# is whole; 63 words (4-byte copies, a short last chunk); M and N ragged
# for the 32 x 32 tile
XNOR_SPLIT_SHAPES = [(40, 2048, 72), (77, 2016, 130), (1, 2048, 8)]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m,k,n", XNOR_SPLIT_SHAPES)
def test_binary_matmul_every_split_exact(dev, m, k, n, splits):
    """Each K split the plan can pick, forced through the launcher, equals
    the plain version."""
    from repro_torch.kernels import binary_matmul as bm
    g = _gen(dev, m + k + n + splits)
    pa = pack_bits(torch.randn(m, k, generator=g, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    units = -(-pa.shape[1] // bm.STAGE_WORDS)
    assert splits in splits_for(units)
    got = bm._launch(pa, pw, k, bm.STAGE_WORDS * -(-units // splits))
    torch.cuda.synchronize()
    assert torch.equal(got, binary_matmul_plain(pa, pw, k))


def test_binary_matmul_kernel_refuses_unaligned_base(dev):
    pa = torch.zeros(4 * 32 + 1, dtype=torch.int32, device=dev)[1:].view(4, 32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        binary_matmul(pa, torch.zeros(8, 32, dtype=torch.int32, device=dev), 1024)


# (M, K, N): the MNIST hidden layer at batch 256, ragged M, ragged K; M 1 /
# 16 / 17 / 33 around the 32-row tile and the 16-row warp tile; Kp 12 (the
# 4-byte copies); K 2560, where the plan splits K in two
@pytest.mark.parametrize("m,k,n", [(256, 1024, 1024), (77, 1024, 1024), (40, 100, 64),
                                   (1, 1024, 1024), (16, 1024, 64), (17, 1024, 64),
                                   (33, 1024, 96), (64, 384, 1024), (8, 2560, 1024)])
def test_hybrid_dense_kernel_exact(dev, m, k, n):
    g = _gen(dev, m + k + n)
    pa = pack_bits(torch.randn(m, k, generator=g, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    scale = torch.randn(n, generator=g, device=dev) * 0.1 + 0.5
    shift = torch.randn(n, generator=g, device=dev) * 0.1
    before = hybrid_dense.launches
    got = hybrid_dense(pa, pw, scale, shift, k)
    torch.cuda.synchronize()
    assert hybrid_dense.launches == before + 1
    assert got.shape == (m, n // 32)
    assert torch.equal(got, hybrid_dense_plain(pa, pw, scale, shift, k))


# (M, K, N): a K range of 8 stages, so every split (1, 2, 4, 8 chunks) is
# whole; 63 words (4-byte copies, a short last chunk) with ragged M; M = 1
HYBRID_SPLIT_SHAPES = [(40, 2048, 64), (77, 2016, 96), (1, 2048, 32)]


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m,k,n", HYBRID_SPLIT_SHAPES)
def test_hybrid_dense_every_split_exact(dev, m, k, n, splits):
    """Each K split, forced through the launcher, equals the plain version
    and gives the same bits on a second call (the cluster adds integers)."""
    from repro_torch.kernels import hybrid_dense as hd
    g = _gen(dev, m + k + n + splits)
    pa = pack_bits(torch.randn(m, k, generator=g, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    scale = torch.randn(n, generator=g, device=dev) * 0.1 + 0.5
    shift = torch.randn(n, generator=g, device=dev) * 0.1
    units = -(-pa.shape[1] // hd.STAGE_WORDS)
    assert splits in splits_for(units)
    kchunk = hd.STAGE_WORDS * -(-units // splits)
    got = hd._launch(pa, pw, scale, shift, k, kchunk)
    torch.cuda.synchronize()
    assert torch.equal(got, hybrid_dense_plain(pa, pw, scale, shift, k))
    assert torch.equal(got, hd._launch(pa, pw, scale, shift, k, kchunk))


@pytest.mark.parametrize("k", [1024, 2560])
def test_hybrid_dense_kernel_signed_zero(dev, k):
    """y exactly +0.0 and -0.0 (scale +-1, shift -0.0 where the dot is 0;
    shift -+2 where it is 2) gives bit 1, as y >= 0 does, unsplit and split."""
    m, n = 64, 256
    g = _gen(dev, k)
    pa = pack_bits(torch.randn(m, k, generator=g, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    scale = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev).repeat(n // 4)
    shift = torch.tensor([-0.0, -0.0, -2.0, 2.0], device=dev).repeat(n // 4)
    y = binary_matmul_plain(pa, pw, k).float() * scale + shift
    zeros = y == 0
    assert (zeros & torch.signbit(y)).any() and (zeros & ~torch.signbit(y)).any()
    got = hybrid_dense(pa, pw, scale, shift, k)
    torch.cuda.synchronize()
    assert torch.equal(got, hybrid_dense_plain(pa, pw, scale, shift, k))


def test_hybrid_dense_kernel_refuses_unaligned_base(dev):
    pa = torch.zeros(4 * 32 + 1, dtype=torch.int32, device=dev)[1:].view(4, 32)
    one = torch.ones(32, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        hybrid_dense(pa, torch.zeros(32, 32, dtype=torch.int32, device=dev), one, one, 1024)


def test_hybrid_dense_kernel_refuses_ragged_n(dev):
    pa = torch.zeros(4, 2, dtype=torch.int32, device=dev)
    one = torch.ones(40, device=dev)
    with pytest.raises(ValueError, match="N % 32"):
        hybrid_dense(pa, torch.zeros(40, 2, dtype=torch.int32, device=dev), one, one, 64)


# (M, K, N): the MNIST float layers at batch 256 (fc0's K = 784, which the
# TPU kernel refuses; fc3's N = 10), tiles that divide, ragged all three;
# then N = 8 / 16 (one and two n8 tiles), K = 16 (a quarter stage), odd K
# and N (2-byte loads), M = 1 beside N = 10
@pytest.mark.parametrize("hardtanh", [False, True])
@pytest.mark.parametrize("m,k,n", [(256, 784, 1024), (256, 1024, 10), (256, 512, 1024),
                                   (1, 784, 1024), (77, 100, 130), (64, 16, 8),
                                   (33, 784, 16), (1, 100, 10), (5, 99, 7)])
def test_bf16_matmul_kernel_matches_plain(dev, m, k, n, hardtanh):
    g = _gen(dev, m + k + n)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    before = bf16_matmul.launches
    got = bf16_matmul(a, w, hardtanh=hardtanh)
    torch.cuda.synchronize()
    assert bf16_matmul.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, bf16_matmul_plain(a, w, hardtanh=hardtanh),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(got, bf16_matmul(a, w, hardtanh=hardtanh))   # the same bits


# (M, K, N): a K range of 16 stages, so every split is whole (16-byte
# copies); even K and N that are not multiples of 8 (4-byte copies, a short
# last chunk); odd K and N (2-byte loads)
BF16_DESIGN_SHAPES = [(70, 1024, 72), (40, 998, 70), (17, 999, 9)]


@pytest.mark.parametrize("hardtanh", [False, True])
@pytest.mark.parametrize("design", [0, 1])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
@pytest.mark.parametrize("m,k,n", BF16_DESIGN_SHAPES)
def test_bf16_matmul_every_design_and_split(dev, m, k, n, design, splits, hardtanh):
    """Each tile design (LARGE, SMALL) and K split, forced through the
    launcher: within 2e-2 of the plain version, and the same bits on a
    second call (the split's partials are added in rank order)."""
    from repro_torch.kernels import bf16_matmul as bfm
    g = _gen(dev, m + k + n + design)
    a = torch.randn(m, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(k, n, generator=g, device=dev) / k ** 0.5).to(torch.bfloat16)
    units = -(-k // bfm.STAGE_K)
    assert splits in splits_for(units)
    kchunk = bfm.STAGE_K * -(-units // splits)
    got = bfm._launch(a, w, hardtanh, design, kchunk)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, bf16_matmul_plain(a, w, hardtanh=hardtanh),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(got, bfm._launch(a, w, hardtanh, design, kchunk))


def test_bf16_matmul_kernel_refuses_unaligned_base(dev):
    a = torch.ones(4 * 64 + 1, dtype=torch.bfloat16, device=dev)[1:].view(4, 64)
    w = torch.ones(64, 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bf16_matmul(a, w)


@pytest.mark.parametrize("hybrid", [False, True])
def test_mlp_on_card_matches_cpu(dev, hybrid):
    """The MNIST net's training and eval forwards, and packed inference, on
    the card (B1 in each binary layer) against the same params on the CPU;
    two B1 launches per forward of the hybrid net, none for the float net."""
    params = H.mlp_init(0, hybrid=hybrid, device="cpu")
    params_dev = _to(params, dev)
    x = torch.from_numpy(np.random.default_rng(1).uniform(-1, 1, (64, 784)).astype(np.float32))
    for training in (True, False):
        b0 = binary_matmul.launches
        got, _ = H.mlp_apply(params_dev, x.to(dev), training=training)
        assert binary_matmul.launches - b0 == (2 if hybrid else 0)
        want, _ = H.mlp_apply(params, x, training=training)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    got = H.mlp_apply_packed(H.mlp_pack(params_dev), x.to(dev))
    want = H.mlp_apply_packed(H.mlp_pack(params), x)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


# (causal, G, S, T, kv_len, q_offset): ragged S, per-row kv_len with a row
# of length 1, a query block from further down the sequence, GQA
FLASH_CASES = [
    (True, 1, 40, 40, None, 0),
    (True, 4, 40, 40, [40, 1], 0),
    (False, 1, 24, 40, [33, 7], 0),
    (False, 4, 40, 40, None, 0),
    (True, 4, 24, 56, [56, 41], 32),
    (True, 1, 152, 152, [152, 77], 0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 80, 128])
@pytest.mark.parametrize("causal,g,s,t,kv_len,q_offset", FLASH_CASES)
def test_flash_kernel_matches_plain(dev, dtype, d, causal, g, s, t, kv_len, q_offset):
    hkv = 2
    gen = _gen(dev, d + s + t)
    q, k, v = (torch.randn(2, n, h, d, generator=gen, device=dev).to(getattr(torch, dtype))
               for n, h in ((s, hkv * g), (t, hkv), (t, hkv)))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, kv_len=kvl, q_offset=q_offset)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal, kv_len=kvl, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == v.dtype and got.shape == (2, s, hkv * g, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


# (B, S, T, Hq, D, q_offset, kv_len): the serving path's largest bucket
# (B 8, S = T = 256, 32 heads of 80), its smallest (S = T = 8), and a query
# block from further down whose S is not a multiple of the 64-row tile.
# No row has kv_len 0: there the plain version averages over every key
# and the kernel over the tiles it visits, as the TPU kernel does.
FLASH_SERVING_CASES = [
    (8, 256, 256, 32, 80, 0, None),
    (8, 8, 8, 32, 80, 0, None),
    (4, 100, 228, 32, 80, 128, [228, 200, 129, 150]),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,t,hq,d,q_offset,kv_len", FLASH_SERVING_CASES)
def test_flash_kernel_serving_shapes(dev, dtype, b, s, t, hq, d, q_offset, kv_len):
    gen = _gen(dev, b + s + t)
    q, k, v = (torch.randn(b, n, hq, d, generator=gen, device=dev).to(getattr(torch, dtype))
               for n in (s, t, t))
    kvl = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=dev)
    got = flash_attention(q, k, v, causal=True, kv_len=kvl, q_offset=q_offset)
    want = flash_attention_plain(q, k, v, causal=True, kv_len=kvl, q_offset=q_offset)
    torch.cuda.synchronize()
    assert got.dtype == v.dtype and got.shape == (b, s, hq, d)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dtype],
                               atol=TOLS[dtype])


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 4, 2, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, q, q, causal=True)
    q = torch.zeros(1, 4, 2, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="Dv == D"):
        flash_attention(q, q, q[..., :32].contiguous(), causal=True)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half(), causal=True)
    off = torch.zeros(4 * 2 * 64 + 4, device=dev, dtype=torch.bfloat16)[4:].view(1, 4, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(off, q, q, causal=True)


def test_smoke_model_on_card_matches_cpu(dev):
    """The smoke LM (f32, its int8 binary FFN kept) prefilled on the card —
    flash kernel and int8 kernel — against the same params on the CPU,
    which run the plain versions; with the launch counts of one forward."""
    cfg = smoke_config("stablelm-3b").replace(compute_dtype="float32",
                                              param_dtype="float32")
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    params_dev = _to(params, dev)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 16)).astype(np.int32)
    lens = np.array([16, 9, 2], np.int32)
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    i0, f0 = int8_matmul.launches, flash_attention.launches
    got, _ = api.prefill(params_dev, {"tokens": torch.from_numpy(toks).to(dev)},
                         max_len=24, seq_lens=torch.from_numpy(lens).to(dev))
    assert int8_matmul.launches - i0 == 2 * n_binary
    assert flash_attention.launches - f0 == cfg.n_layers
    want, _ = api.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=24,
                          seq_lens=torch.from_numpy(lens))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


# (rows, D): one row, a ragged row count, the decode insert (8 x 32 rows of
# 80) and a prefill-sized block; D = 16 (one word), 80 (16 pad bits), 129
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d", [(1, 80), (7, 16), (7, 129), (256, 80), (4103, 80),
                                 (33, 129)])
def test_kv_quant_kernels_exact(dev, n, d, dtype):
    g = _gen(dev, n + d)
    x = (torch.randn(n, d, generator=g, device=dev) * 3).to(getattr(torch, dtype))
    x[n // 2] = 0.0                                  # a zero scale divides by 1
    counts = [f.launches for f in (kvq.kv_quant_int8, kvq.kv_dequant_int8,
                                   kvq.kv_quant_binary, kvq.kv_dequant_binary)]
    q, s = kvq.kv_quant_int8(x)
    p, ps = kvq.kv_quant_binary(x)
    deq = {dt: (kvq.kv_dequant_int8(q, s, dtype=dt), kvq.kv_dequant_binary(p, ps, d, dtype=dt))
           for dt in (torch.float32, torch.bfloat16)}
    torch.cuda.synchronize()
    assert [f.launches for f in (kvq.kv_quant_int8, kvq.kv_dequant_int8, kvq.kv_quant_binary,
                                 kvq.kv_dequant_binary)] == [c + k for c, k in
                                                            zip(counts, (1, 2, 1, 2))]
    pq, pqs = kvq.kv_quant_int8_plain(x)
    pp, pps = kvq.kv_quant_binary_plain(x)
    assert torch.equal(q, pq) and torch.equal(_bits(s), _bits(pqs))
    assert torch.equal(p, pp) and torch.equal(_bits(ps), _bits(pps))
    for dt, (d8, db) in deq.items():
        assert torch.equal(_bits(d8), _bits(kvq.kv_dequant_int8_plain(q, s, dt)))
        assert torch.equal(_bits(db), _bits(kvq.kv_dequant_binary_plain(p, ps, d, dt)))


def test_kv_quant_kernels_take_leading_dims_and_refuse_f16(dev):
    x = torch.randn(2, 3, 4, 80, device=dev, dtype=torch.bfloat16)
    q, s = kvq.kv_quant_int8(x)
    assert q.shape == x.shape and s.shape == (2, 3, 4)
    p, ps = kvq.kv_quant_binary(x[:, 1:])             # a strided view
    assert p.shape == (2, 2, 4, 3) and torch.equal(p, kvq.kv_quant_binary_plain(x[:, 1:])[0])
    with pytest.raises(TypeError, match="bf16 or f32"):
        kvq.kv_quant_int8(x.half())


def _pool_leaves(codec, nb, t, h, d, dev, g):
    """Random codes and scales for a pool of nb x t rows of h heads, so
    rows the insert kernel must not touch are told apart from zeros."""
    width = d if codec == "int8" else -(-d // 32)
    lo, hi, dt = (-127, 128, torch.int8) if codec == "int8" else (-2 ** 31, 2 ** 31, torch.int32)

    def codes():
        return torch.randint(lo, hi, (nb, t, h, width), generator=g, device=dev, dtype=dt)

    def scales():
        return torch.rand(nb, t, h, generator=g, device=dev).to(torch.bfloat16)
    return dict(zip(kvq.leaf_names(codec), (codes(), scales(), codes(), scales())))


def _same_leaves(a: dict, b: dict) -> bool:
    return all(torch.equal(_bits(a[n]), _bits(b[n])) for n in a)


# the decode insert: lengths 0, 1, T - 1 and T (clamped to T - 1 on the
# contiguous pool; past the table's pages, so the spare block, on the paged
# one), and a free slot (len 0, all holes on the paged pool)
INSERT_LENS = [0, 1, 31, 32, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 64, 80, 96, 128, 129])
@pytest.mark.parametrize("codec", ["int8", "binary"])
def test_kv_insert_kernel_matches_plain(dev, codec, d, dtype):
    """The insert kernel (B4a / B4c) in its four modes against its plain
    version, bit for bit: (a) rows, (b) the contiguous decode insert, (c)
    the paged one, (d) the prefill encode into a zero-padded cache. Every
    pool byte outside the written rows is unchanged, a second call writes
    the same bits, the paged pool gets the contiguous pool's rows, and each
    call counts one launch."""
    g = _gen(dev, 7 * d + len(dtype))
    dt = getattr(torch, dtype)
    quant = getattr(kvq, f"kv_quant_{codec}")
    plain = getattr(kvq, f"kv_quant_{codec}_plain")
    names = kvq.leaf_names(codec)
    h, t, bs = 3, 32, 8
    b = len(INSERT_LENS)

    # (a) rows, with an all-zero row
    x = (torch.randn(37, h, d, generator=g, device=dev) * 3).to(dt)
    x[5] = 0.0
    before = quant.launches
    (wc, ws), (pc, ps) = quant(x), plain(x)
    torch.cuda.synchronize()
    assert quant.launches == before + 1
    assert torch.equal(wc, pc) and torch.equal(_bits(ws), _bits(ps))

    k, v = ((torch.randn(b, 1, h, d, generator=g, device=dev) * 3).to(dt) for _ in range(2))
    k[2] = 0.0
    lens = torch.tensor(INSERT_LENS, dtype=torch.int32, device=dev)

    # (b) contiguous
    pool = _pool_leaves(codec, b, t, h, d, dev, g)
    runs = []
    for _ in range(2):
        leaves = {n: a.clone() for n, a in pool.items()}
        before = quant.launches
        new_lens = kvq.kv_insert(codec, leaves, k, v, lens)
        torch.cuda.synchronize()
        assert quant.launches == before + 1
        runs.append(leaves)
    want = {n: a.clone() for n, a in pool.items()}
    want_lens = kvq.kv_insert_plain(codec, want, k, v, lens)
    assert torch.equal(new_lens, want_lens) and lens.tolist() == INSERT_LENS
    assert _same_leaves(runs[0], want) and _same_leaves(runs[1], want)
    at = [min(n, t - 1) for n in INSERT_LENS]
    written = torch.zeros(b, t, dtype=torch.bool, device=dev)
    written[torch.arange(b), torch.tensor(at)] = True
    for n in names:
        assert torch.equal(_bits(runs[0][n])[~written], _bits(pool[n])[~written])

    # (c) paged: shuffled blocks, holes, a slot past its pages, a free slot
    cont = runs[0]
    n_pages, n_blocks = t // bs, 12
    perm = torch.randperm(n_blocks, generator=g, device=dev).tolist()
    table = torch.full((b, n_pages), n_blocks + 2, dtype=torch.int32)
    for i, n in enumerate(INSERT_LENS[:-1]):
        for p in range(min(n // bs + 1, n_pages)):
            table[i, p] = perm.pop()
    ppool = _pool_leaves(codec, n_blocks + 1, bs, h, d, dev, g)
    runs = []
    for _ in range(2):
        leaves = {n: a.clone() for n, a in ppool.items()}
        new_lens = kvq.kv_insert(codec, leaves, k, v, lens, table=table.to(dev))
        torch.cuda.synchronize()
        runs.append(leaves)
    want = {n: a.clone() for n, a in ppool.items()}
    want_lens = kvq.kv_insert_plain(codec, want, k, v, lens, table=table.to(dev))
    assert torch.equal(new_lens, want_lens)
    # the addressed blocks are exact and repeat; the spare block takes two
    # rows at offset 0 (the free slot's and the slot's past its pages), in
    # no set order
    addressed = [{n: a[:-1] for n, a in r.items()} for r in (*runs, want)]
    assert _same_leaves(addressed[0], addressed[2]) and _same_leaves(addressed[1], addressed[2])
    written = torch.zeros(n_blocks + 1, bs, dtype=torch.bool, device=dev)
    for i, n in enumerate(INSERT_LENS):
        blk = int(table[i, n // bs]) if n // bs < n_pages else n_blocks
        blk = min(blk, n_blocks)
        written[blk, n % bs] = True
        if blk < n_blocks:                 # the contiguous pool's row, bit for bit
            for name in names:
                assert torch.equal(_bits(runs[0][name][blk, n % bs]), _bits(cont[name][i, n]))
    assert bool(written[n_blocks, 0])
    for n in names:
        assert torch.equal(_bits(runs[0][n])[~written], _bits(ppool[n])[~written])

    # (d) prefill into a zero-padded cache, over memory left dirty
    kp, vp = ((torch.randn(b, 13, h, d, generator=g, device=dev) * 3).to(dt) for _ in range(2))
    kp[1, 4] = 0.0
    junk = torch.full((1 << 22,), -1, dtype=torch.int32, device=dev)
    del junk
    before = quant.launches
    got, again = kvq.kv_prefill(codec, kp, vp, t), kvq.kv_prefill(codec, kp, vp, t)
    want = kvq.kv_prefill_plain(codec, kp, vp, t)
    torch.cuda.synchronize()
    assert quant.launches == before + 2
    assert set(got) == set(want) == set(names)
    assert _same_leaves(got, want) and _same_leaves(again, want)


def test_kv_insert_kernel_refuses_what_it_does_not_take(dev):
    k = torch.randn(2, 1, 4, 80, device=dev, dtype=torch.bfloat16)
    cache = {**_pool_leaves("int8", 2, 16, 4, 80, dev, _gen(dev, 3)),
             "len": torch.tensor([3, 16], dtype=torch.int32, device=dev)}
    lens = cache["len"]
    kvq.kv_insert("int8", cache, k, k, lens)
    with pytest.raises(TypeError, match="bf16 or f32"):
        kvq.kv_insert("int8", cache, k.half(), k.half(), lens)
    with pytest.raises(TypeError, match="one dtype"):
        kvq.kv_insert("int8", cache, k, k.float(), lens)
    with pytest.raises(ValueError, match="does not fit"):
        kvq.kv_insert("int8", cache, k.expand(2, 17, 4, 80).contiguous(),
                      k.expand(2, 17, 4, 80).contiguous(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        kvq.kv_insert("int8", cache, k.transpose(0, 2), k.transpose(0, 2), lens)
    with pytest.raises(TypeError, match="lens"):
        kvq.kv_insert("int8", cache, k, k, lens.long())
    with pytest.raises(ValueError, match="lens"):
        kvq.kv_insert("int8", cache, k, k, lens.cpu())
    with pytest.raises(TypeError, match="k_s"):
        kvq.kv_insert("int8", {**cache, "k_s": cache["k_s"].float()}, k, k, lens)
    with pytest.raises(TypeError, match="k_p"):
        kvq.kv_insert("binary", {**cache, "k_p": cache["k_q"], "v_p": cache["v_q"]}, k, k,
                      lens)
    with pytest.raises(ValueError, match="v_q"):
        kvq.kv_insert("int8", {**cache, "v_q": cache["v_q"][:, :8].contiguous()}, k, k, lens)
    with pytest.raises(ValueError, match="contiguous leaves hold"):
        kvq.kv_insert("int8", cache, k[:1].contiguous(), k[:1].contiguous(),
                      lens[:1].contiguous())
    table = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="table"):
        kvq.kv_insert("int8", cache, k, k, lens, table=table)
    with pytest.raises(ValueError, match="int8 or binary"):
        kvq.kv_insert("bf16", cache, k, k, lens)
    wide = torch.randn(2, 1, 4, 264, device=dev)
    with pytest.raises(ValueError, match="head dims"):
        kvq.kv_prefill("int8", wide, wide, 4)
    with pytest.raises(ValueError, match="head dims"):
        kvq.kv_quant_binary(wide)
    with pytest.raises(ValueError, match="max_len"):
        kvq.kv_prefill("binary", k.expand(2, 5, 4, 80).contiguous(),
                       k.expand(2, 5, 4, 80).contiguous(), 4)


# the verify's span insert (S 4 into T 32): lengths within T, clamped at
# T - S (30, 32), and a free slot; on the paged pool (block 8) spans that
# cross a page, run past the table's pages, and meet a hole
SPAN_LENS = [0, 5, 30, 32, 13]
SPAN_S = 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 80, 129])
@pytest.mark.parametrize("codec", ["int8", "binary"])
def test_kv_insert_span_kernel_matches_plain(dev, codec, d, dtype):
    """The insert kernel's span mode (the speculative verify's write) bit
    for bit against kv_insert_plain's span on both pools: every written row
    exact (the spare block aside, which takes the dropped rows in no set
    order), every other byte unchanged, a second call the same, the lengths
    advanced by S, one launch a call."""
    g = _gen(dev, 11 * d + len(dtype))
    dt = getattr(torch, dtype)
    quant = getattr(kvq, f"kv_quant_{codec}")
    names = kvq.leaf_names(codec)
    h, t, bs = 3, 32, 8
    b = len(SPAN_LENS)
    k, v = ((torch.randn(b, SPAN_S, h, d, generator=g, device=dev) * 3).to(dt) for _ in range(2))
    k[1, 2] = 0.0
    lens = torch.tensor(SPAN_LENS, dtype=torch.int32, device=dev)
    n_pages, n_blocks = t // bs, 16
    perm = torch.randperm(n_blocks, generator=g, device=dev).tolist()
    table = torch.full((b, n_pages), n_blocks + 1, dtype=torch.int32)
    for i, p in ((1, 0), (1, 1), (2, 3), (3, 0), (3, 3), (4, 1)):  # slot 4: a hole at page 2
        table[i, p] = perm.pop()
    table[0] = n_blocks                    # slot 0 free: all holes
    for tab, nb, tt in ((None, b, t), (table.to(dev), n_blocks + 1, bs)):
        pool = _pool_leaves(codec, nb, tt, h, d, dev, g)
        runs = []
        for _ in range(2):
            leaves = {n: a.clone() for n, a in pool.items()}
            before = quant.launches
            new_lens = kvq.kv_insert(codec, leaves, k, v, lens, table=tab)
            torch.cuda.synchronize()
            assert quant.launches == before + 1
            runs.append(leaves)
        want = {n: a.clone() for n, a in pool.items()}
        want_lens = kvq.kv_insert_plain(codec, want, k, v, lens, table=tab)
        assert torch.equal(new_lens, want_lens)
        assert new_lens.tolist() == [n + SPAN_S for n in SPAN_LENS]
        cut = slice(None) if tab is None else slice(0, -1)
        for r in runs:
            assert _same_leaves({n: a[cut] for n, a in r.items()},
                                {n: a[cut] for n, a in want.items()})
        written = torch.zeros(nb, tt, dtype=torch.bool, device=dev)
        for i, n in enumerate(SPAN_LENS):
            for j in range(SPAN_S):
                if tab is None:
                    written[i, min(n, t - SPAN_S) + j] = True
                else:
                    p = n + j
                    blk = int(table[i, p // bs]) if p // bs < n_pages else n_blocks
                    written[min(blk, n_blocks), p % bs] = True
        for n in names:
            assert torch.equal(_bits(runs[0][n])[~written], _bits(pool[n])[~written])


# (B, Hq, Hkv, D, T, lens, q dtype): the kv_decode phase of chip_smoke.py at
# small sizes (G 1 and 4, D 64 / 80 / 128, bf16 and f32 q), plus T 320 (ten
# chunks of 32 for 8 warps: a warp takes two) and G 8 (8 query rows)
DECODE_CASES = [
    (4, 4, 4, 80, 64, [40, 1, 0, 64], "bfloat16"),
    (4, 4, 4, 80, 64, [40, 1, 0, 64], "float32"),
    (3, 8, 2, 80, 48, [17, 48, 5], "bfloat16"),
    (2, 4, 4, 64, 32, [32, 9], "bfloat16"),
    (2, 2, 2, 128, 48, [3, 47], "float32"),
    (3, 2, 2, 80, 320, [320, 257, 33], "float32"),
    (2, 16, 2, 80, 32, [31, 0], "float32"),
]
DECODE_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
PAGE = 16


def _decode_pools(kv, b, t, hkv, d, lens, dev, g):
    """The codec's leaves on the contiguous pool and on a paged one (block
    16, the same values in shuffled blocks, holes at and past each slot's
    ceil(len / 16)-th page) -> (contiguous, paged, table)."""
    quant = kvq.kv_quant_int8 if kv == "int8" else kvq.kv_quant_binary
    (kc, ks), (vc, vs) = (quant(torch.randn(b, t, hkv, d, generator=g, device=dev))
                          for _ in range(2))
    cont = [kc, ks, vc, vs]
    used = [-(-n // PAGE) for n in lens]
    n_blocks = sum(used) + 2
    perm = torch.randperm(n_blocks, generator=g, device=dev).tolist()
    table = torch.full((b, t // PAGE), n_blocks + 9, dtype=torch.int32)
    paged = [x.new_zeros((n_blocks + 1, PAGE, *x.shape[2:])) for x in cont]
    for i, u in enumerate(used):
        for p in range(u):
            blk = perm.pop()
            table[i, p] = blk
            for dst, src in zip(paged, cont):
                dst[blk] = src[i, p * PAGE:(p + 1) * PAGE]
    return cont, paged, table.to(dev)


@pytest.mark.parametrize("kv", ["int8", "binary"])
@pytest.mark.parametrize("b,hq,hkv,d,t,lens,dtype", DECODE_CASES)
def test_kv_decode_kernel_matches_plain(dev, kv, b, hq, hkv, d, t, lens, dtype):
    g = _gen(dev, b * t + d)
    q = torch.randn(b, 1, hq, d, generator=g, device=dev).to(getattr(torch, dtype))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    live = lens_t > 0
    wrapper = getattr(kvd, f"kv_decode_{kv}")
    plain = getattr(kvd, f"kv_decode_{kv}_plain")
    extra = () if kv == "int8" else (d,)
    cont, paged, table = _decode_pools(kv, b, t, hkv, d, lens, dev, g)
    outs = []
    for leaves, tab in ((cont, None), (paged, table)):
        before = wrapper.launches
        got = wrapper(q, *leaves, lens_t, *extra, table=tab)
        again = wrapper(q, *leaves, lens_t, *extra, table=tab)
        want = plain(q, *leaves, lens_t, *extra, table=tab)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert got.shape == q.shape and got.dtype == q.dtype
        assert torch.equal(_bits(got), _bits(again))
        torch.testing.assert_close(got[live].float(), want[live].float(),
                                   atol=DECODE_TOL[dtype], rtol=0)
        assert not bool(got[~live].any())
        outs.append(got)
    assert torch.equal(_bits(outs[0]), _bits(outs[1]))


def test_kv_decode_kernel_refuses_what_it_does_not_take(dev):
    g = _gen(dev, 5)
    q = torch.randn(2, 1, 4, 80, generator=g, device=dev)
    (kc, ks), (vc, vs) = (kvq.kv_quant_int8(torch.randn(2, 16, 2, 80, device=dev))
                          for _ in range(2))
    lens = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    kvd.kv_decode_int8(q, kc, ks, vc, vs, lens)
    with pytest.raises(TypeError, match="bf16 or f32 q"):
        kvd.kv_decode_int8(q.half(), kc, ks, vc, vs, lens)
    with pytest.raises(TypeError, match="k_s"):
        kvd.kv_decode_int8(q, kc, ks.float(), vc, vs, lens)
    with pytest.raises(TypeError, match="lens"):
        kvd.kv_decode_int8(q, kc, ks, vc, vs, lens.long())
    with pytest.raises(TypeError, match="k codes"):
        kvd.kv_decode_binary(q, kc, ks, vc, vs, lens, 80)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        kvd.kv_decode_int8(q[:, :, :3].contiguous(), kc, ks, vc, vs, lens)
    wide = torch.randn(2, 1, 4, 144, device=dev)
    (wk, wks), (wv, wvs) = (kvq.kv_quant_int8(torch.randn(2, 16, 2, 144, device=dev))
                            for _ in range(2))
    with pytest.raises(ValueError, match="head dims"):
        kvd.kv_decode_int8(wide, wk, wks, wv, wvs, lens)
    with pytest.raises(ValueError, match="16-byte"):
        kvd.kv_decode_int8(q[..., :72].contiguous(), kc[..., :72].contiguous(), ks,
                           vc[..., :72].contiguous(), vs, lens)
    with pytest.raises(ValueError, match="query rows"):
        kvd.kv_decode_int8(torch.randn(2, 1, 18, 80, device=dev), kc, ks, vc, vs, lens)


# (B, Hq, Hkv, D, T, lens, S, q dtype): the verify's per-query lengths. G 1
# at S 4 (stablelm-3b at k = 3: one launch), G 4 at S 3 (12 rows: two
# launches) and G 1 at S 9 (two launches)
Q_LENS_CASES = [
    (4, 4, 4, 80, 64, [40, 1, 0, 60], 4, "float32"),
    (4, 4, 4, 80, 64, [40, 1, 0, 60], 4, "bfloat16"),
    (3, 8, 2, 64, 48, [17, 44, 5], 3, "float32"),
    (2, 2, 2, 128, 48, [3, 38], 9, "bfloat16"),
]


@pytest.mark.parametrize("kv", ["int8", "binary"])
@pytest.mark.parametrize("b,hq,hkv,d,t,lens,s,dtype", Q_LENS_CASES)
def test_kv_decode_q_lens_kernel_matches_plain(dev, kv, b, hq, hkv, d, t, lens, s, dtype):
    """kv_decode with q_lens (query j of slot b below lens[b] + j + 1, the
    verify's limits) against its plain version (1e-4 f32 q, 2e-2 bf16 q),
    one launch per chunk of kv_decode.query_chunks, the same bits on both
    pools and on a second call."""
    g = _gen(dev, b * t + d + s)
    q = torch.randn(b, s, hq, d, generator=g, device=dev).to(getattr(torch, dtype))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q_lens = (lens_t[:, None] + torch.arange(1, s + 1, device=dev)[None]).to(torch.int32)
    wrapper = getattr(kvd, f"kv_decode_{kv}")
    plain = getattr(kvd, f"kv_decode_{kv}_plain")
    extra = () if kv == "int8" else (d,)
    cont, paged, table = _decode_pools(kv, b, t, hkv, d, [n + s for n in lens], dev, g)
    n_launch = len(kvd.query_chunks(s, hq // hkv))
    outs = []
    for leaves, tab in ((cont, None), (paged, table)):
        before = wrapper.launches
        got = wrapper(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens)
        again = wrapper(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens)
        want = plain(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2 * n_launch
        assert torch.equal(_bits(got), _bits(again))
        torch.testing.assert_close(got.float(), want.float(), atol=DECODE_TOL[dtype], rtol=0)
        outs.append(got)
    assert torch.equal(_bits(outs[0]), _bits(outs[1]))
    # without q_lens every query attends below len: as if each had len
    same = wrapper(q, *cont, lens_t, *extra,
                   q_lens=lens_t[:, None].expand(b, s).contiguous())
    torch.testing.assert_close(same, wrapper(q, *cont, lens_t, *extra), atol=0, rtol=0)


def _smoke_engine_runs(dev, **kw):
    """The smoke LM (binary FFNs in the middle block, f32) on the card,
    served eagerly and through CUDA graphs: (tokens eager, tokens graphed,
    the graphed engine, the launch counts of each run)."""
    cfg = smoke_config("stablelm-3b").replace(compute_dtype="float32", param_dtype="float32")
    api = get_model(cfg)
    params = _to(api.init(0, device="cpu"), dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, 4 + 3 * i) for i in range(5)]
    outs, engs, launches = [], [], []
    for graphs in (False, True):
        eng = ServeEngine(api, params, max_batch=2, max_len=64, cuda_graphs=graphs, **kw)
        before = {w.__name__: w.launches for w in GRAPH_COUNTED}
        rids = [eng.add_request(p, max_new=8) for p in prompts]
        res = eng.run()
        outs.append([res[r] for r in rids])
        engs.append(eng)
        launches.append({w.__name__: w.launches - before[w.__name__] for w in GRAPH_COUNTED})
    return outs, engs, launches


@pytest.mark.parametrize("kw", [dict(kv_cache="int8"),
                                dict(kv_cache="binary", kv_block_size=8),
                                dict(kv_cache="int8", temperature=0.8, seed=3),
                                dict(kv_cache="int8", spec_k=3),
                                dict(kv_cache="int8", kv_block_size=8, spec_k=3,
                                     temperature=0.8, seed=3)],
                         ids=["int8", "binary-paged", "int8-sampled", "spec", "spec-paged-sampled"])
def test_graph_replay_equals_eager_on_card(dev, kw):
    """Each decode tick (or speculative wave) replayed as one CUDA graph
    gives the eager engine's tokens, one replay a step; every kernel's
    launches equal the eager run's (the warm-up and the capture do not
    count); a spec engine counts one draft launch a wave, with B1 in the
    draft's float FFNs."""
    (eager, graphed), (e0, e1), (l0, l1) = _smoke_engine_runs(dev, **kw)
    assert graphed == eager
    assert e1.stats == e0.stats
    assert e1.graph.replays == e1.stats["decode_steps"] and e0.graph is None
    assert l1 == l0
    if kw.get("spec_k"):
        assert e1.stats["spec_draft_launches"] == e1.stats["spec_waves"]
        assert l1["binary_matmul"] == 3 * 2 * kw["spec_k"] * e1.stats["spec_waves"]


def test_graph_counts_each_replay(dev):
    """After N replays a wrapper's count has grown by N x what one eager
    call adds, and the warm-up and the capture added nothing."""
    from repro_torch.serving.graphs import StepGraph
    g = _gen(dev, 3)
    a = pack_signs_int8(torch.randn(8, 256, generator=g, device=dev))
    pw = pack_bits(torch.randn(64, 256, generator=g, device=dev))
    state = torch.zeros(4, dtype=torch.int32, device=dev)

    def fn():
        state.add_(1)
        return (int8_matmul(a, pw), int8_matmul(a, pw))

    step = StepGraph(fn, dev, keep=[state])
    before = int8_matmul.launches
    for n in range(1, 4):
        out = step()
        torch.cuda.synchronize()
        assert int8_matmul.launches == before + 2 * n and step.replays == n
        assert state.tolist() == [n] * 4            # the warm-up left no trace
    assert torch.equal(out[0], int8_matmul_plain(a, pw))


def _markov(start, n, vocab):
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return np.asarray(out, np.int64)


def _float_leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        return [t for v in tree for t in _float_leaves(v)]
    return [tree] if tree.is_floating_point() else []


@pytest.fixture(scope="module")
def markov_lm():
    """The smoke LM with float FFNs (f32), trained on the CPU for 200 AdamW
    steps on the affine-Markov map x -> (7x + 13) mod vocab: the torch twin
    of tests/conftest.py's ``trained_lm`` (this file imports no jax). Its
    argmax gaps of several logits let the binarized self-draft agree with
    the target, which random weights at any width barely do. Skips without
    a card, so the training runs only where the tests do."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from repro_torch.configs.base import PrecisionPolicy
    from repro_torch.models import lm_common as lc
    from repro_torch.models import transformer as tr
    cfg = smoke_config("stablelm-3b").replace(policy=PrecisionPolicy(), compute_dtype="float32",
                                              param_dtype="float32")
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    leaves = _float_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=1e-3)
    rng = np.random.default_rng(0)
    pos = torch.arange(16)
    for _ in range(200):
        toks = torch.as_tensor(np.stack([_markov(int(x), 17, cfg.vocab)
                                         for x in rng.integers(0, cfg.vocab, 32)]))
        h, _ = lc.segments_prefill(params["blocks"], tr._embed(params, cfg, toks[:, :-1]), cfg,
                                   positions=pos, max_len=16)
        logits = tr._logits(params, cfg, h)[..., :cfg.vocab]
        loss = torch.nn.functional.cross_entropy(logits.reshape(-1, cfg.vocab),
                                                 toks[:, 1:].reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
    for t in leaves:
        t.requires_grad_(False)
    assert float(loss.detach()) < 0.2
    return cfg, api, params


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "binary"])
def test_spec_on_trained_lm_accepts_on_card(dev, markov_lm, kv, pool):
    """Speculative decoding (k = 3, greedy) of a trained LM on the card, on
    each codec and both pools (the paged one with the prefix cache, so
    blocks filled inside a wave are published and hit): drafts are
    accepted on every path, the graph replays give the eager waves' tokens
    and stats, and one draft launch and one replay make a wave. Tokens are
    held to the eager engine's, not to the plain engine's: on a card the
    verify and the decode round differently (serving/engine.py)."""
    cfg, api, params = markov_lm
    params = _to(params, dev)
    prompts = [_markov(3 if i % 2 == 0 else 50, 4 + 3 * i, cfg.vocab) for i in range(5)]
    kw = dict(kv_cache=kv, spec_k=3)
    if pool == "paged":
        kw.update(kv_block_size=8, prefix_cache=True)
    outs, engs = [], []
    for graphs in (False, True):
        eng = ServeEngine(api, params, max_batch=2, max_len=64, cuda_graphs=graphs, **kw)
        rids = [eng.add_request(p, max_new=8) for p in prompts]
        res = eng.run()
        outs.append([res[r] for r in rids])
        engs.append(eng)
    eager, graphed = engs
    assert outs[1] == outs[0] and all(len(o) == 8 for o in outs[1])
    assert graphed.stats == eager.stats
    assert graphed.graph.replays == graphed.stats["spec_waves"] == \
        graphed.stats["spec_draft_launches"] > 0
    assert graphed.acceptance_rate() > 0
    if pool == "paged":
        assert graphed.pool.stats["hits"] > 0


@pytest.mark.parametrize("kv", ["int8", "binary"])
def test_short_quantized_and_paged_serve_on_card(dev, kv):
    """The smoke LM (f32) served on the card: the contiguous and the paged
    pool (block 8) of one codec give the same tokens (the kv_decode kernel
    sums in an order that depends on positions only), with the codec's
    insert kernel launched once per layer per wave and per step (K and V in
    one launch), kv_decode once per layer per step, and the codec's
    dequantizer only for a cached prefix's context (2 x layers per wave
    that has one); the prefix cache then hits on a shared header. (Tokens
    across batch shapes are not compared: the random-init model's top-2 gaps
    sit at float noise.)"""
    cfg = smoke_config("stablelm-3b").replace(compute_dtype="float32",
                                              param_dtype="float32")
    api = get_model(cfg)
    params = _to(api.init(0, device="cpu"), dev)
    rng = np.random.default_rng(0)
    header = rng.integers(0, cfg.vocab, 16)
    prompts = [np.concatenate([header, rng.integers(0, cfg.vocab, 3 + i)]) for i in range(4)]
    quant, dequant = getattr(kvq, f"kv_quant_{kv}"), getattr(kvq, f"kv_dequant_{kv}")
    decode = getattr(kvd, f"kv_decode_{kv}")
    outs = []
    for kw in ({}, {"kv_block_size": 8}):
        eng = ServeEngine(api, params, max_batch=2, max_len=48, kv_cache=kv, **kw)
        before = (quant.launches, dequant.launches, decode.launches)
        rids = [eng.add_request(p, max_new=5) for p in prompts]
        res = eng.run()
        outs.append([res[r] for r in rids])
        waves, steps = eng.stats["prefills"], eng.stats["decode_steps"]
        assert (quant.launches - before[0], dequant.launches - before[1],
                decode.launches - before[2]) == (cfg.n_layers * (waves + steps), 0,
                                                 cfg.n_layers * steps)
    assert outs[0] == outs[1]
    eng = ServeEngine(api, params, max_batch=2, max_len=48, kv_cache=kv, kv_block_size=8,
                      prefix_cache=True)
    rids = [eng.add_request(prompts[0], max_new=5)]
    eng.run()
    d_before = dequant.launches
    rids += [eng.add_request(p, max_new=5) for p in prompts[1:]]
    res = eng.run()
    assert eng.stats["cached_prompt_tokens"] == 3 * 16 and all(len(res[r]) == 5 for r in rids)
    assert dequant.launches - d_before == 2 * cfg.n_layers * (eng.stats["prefills"] - 1)


@pytest.mark.parametrize("pool", ["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["bf16", "int8", "binary"])
def test_interleave_equals_blocking_on_card(dev, markov_lm, kv, pool):
    """Interleaved prefill (chunk 4) of the trained LM on the card, each
    decode tick a graph replay: the tokens equal the chunked blocking
    engine's (the same kernels on the same shapes) and, for bf16 and int8,
    the monolithic blocking engine's (flash prefill), as on the CPU; binary
    K/V of earlier chunks change what a later chunk attends to, so its
    monolithic tokens are not held. Per wrapper, the interleaved run
    launches what the chunked one does."""
    cfg, api, params = markov_lm
    params = _to(params, dev)
    prompts = [_markov(3 + i, 7 + (i % 4) * 3, cfg.vocab) for i in range(5)]
    kw = dict(kv_cache=kv)
    if pool == "paged":
        kw.update(kv_block_size=8, prefix_cache=True)
    outs, launches = [], []
    for extra in ({}, {"prefill_chunk": 4}, {"prefill_chunk": 4, "interleave": True}):
        eng = ServeEngine(api, params, max_batch=2, max_len=64, **kw, **extra)
        before = {w.__name__: w.launches for w in GRAPH_COUNTED}
        rids = [eng.add_request(p, max_new=8) for p in prompts]
        res = eng.run()
        outs.append([res[r] for r in rids])
        launches.append({w.__name__: w.launches - before[w.__name__] for w in GRAPH_COUNTED})
    mono, chunked, inter = outs
    assert inter == chunked and all(len(o) == 8 for o in inter)
    if kv != "binary":
        assert inter == mono
    assert eng.stats["prefill_slices"] > 0 and eng.graph.replays == eng.stats["decode_steps"]
    if eng.stats["decode_steps"] == 0 or launches[1]["flash_attention"] or \
            launches[2]["flash_attention"]:
        raise AssertionError(f"chunked prefill ran the flash kernel: {launches}")


def test_prefill_slice_needs_no_host_sync(dev):
    """A non-final slice of an interleaved job (tokens and lengths already
    on the device, its transient cache allocated) runs under
    torch.cuda.set_sync_debug_mode("error"): nothing in it waits for the
    device."""
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    params = _to(api.init(0, device="cpu"), dev)
    for kv in ("bf16", "int8", "binary"):
        eng = ServeEngine(api, params, max_batch=2, max_len=64, kv_cache=kv, interleave=True,
                          prefill_chunk=8)
        eng.add_request(np.arange(20) % cfg.vocab, max_new=2)
        eng.run()                                  # builds the kernels, warms the shapes
        eng.add_request(np.arange(30) % cfg.vocab, max_new=2)
        eng._start_jobs()
        (job,) = eng._jobs
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            assert eng._advance_job(job) is False and eng._advance_job(job) is False
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert job.pos == 16 < job.todo
        eng.run()


@pytest.mark.parametrize("kw", [dict(kv_cache="int8", interleave=True, prefill_chunk=4),
                                dict(kv_cache="int8", kv_block_size=8, prefix_cache=True,
                                     spec_k=2, interleave=True)],
                         ids=["int8-interleave", "int8-paged-spec-interleave"])
def test_telemetry_on_off_same_launches_on_card(dev, kw):
    """Telemetry on and off, each tick a graph replay: the same tokens, the
    same launches per wrapper and the same replays."""
    from repro_torch.serving.telemetry import Telemetry
    cfg = smoke_config("stablelm-3b").replace(compute_dtype="float32", param_dtype="float32")
    api = get_model(cfg)
    params = _to(api.init(0, device="cpu"), dev)
    prompts = [np.arange(4 + 3 * i) % cfg.vocab for i in range(5)]
    runs = []
    for tm in (None, Telemetry()):
        eng = ServeEngine(api, params, max_batch=2, max_len=64, telemetry=tm, **kw)
        before = {w.__name__: w.launches for w in GRAPH_COUNTED}
        rids = [eng.add_request(p, max_new=6) for p in prompts]
        res = eng.run()
        runs.append(([res[r] for r in rids],
                     {w.__name__: w.launches - before[w.__name__] for w in GRAPH_COUNTED},
                     eng.graph.replays, dict(eng.stats)))
    assert runs[0] == runs[1]
    assert runs[1][2] == runs[1][3]["decode_steps"] > 0
    assert tm.prefill_slice_s.count == runs[1][3]["prefill_slices"] > 0
