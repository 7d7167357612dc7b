"""The recurrent families on the card: the int8-binary GEMM (B2) at the
shapes their binary denses give it, and their smoke models on the card
against the CPU.

Every test carries the ``cuda`` marker and skips without an NVIDIA GPU.
The file imports no jax and nothing of ``repro``, so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_recurrent_cuda.py

  * B2 at zamba2-2.7b's in_zx (N, K) = (10240, 2560) and out (2560, 5120)
    and rwkv6-3b's c_k (8960, 2560) and c_v (2560, 8960: K = 32 x 280,
    which the TPU kernel's ``bk = min(512, K)`` refuses), at decode M 8 and
    prefill M 1024: exactly the plain version, one launch a call;
  * the smoke zamba2 (f32, on the bf16 and the int8 pool) and rwkv6 (f32)
    prefilled and decoded two steps on the card against the CPU, with the
    launch counts of each call: B2 twice a binary block, B3 once a shared
    invocation a prefill, the insert kernel once an invocation a prefill
    and a step and kv_decode once a step (int8 pool). zamba2's logits
    within 1e-4 of their max-abs (f32 on both devices; its only
    differences come before sign() and are ~1e-6); rwkv6's within 2^-7,
    since its time-mix projections round to bf16 whatever the config says
    (models/rwkv6.py), and cuBLAS and the CPU sum them in other orders.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.binarize import pack_bits, pack_signs_int8  # noqa: E402
from repro_torch.kernels import COUNTED  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda

F32 = dict(compute_dtype="float32", param_dtype="float32")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("n,k", [(10240, 2560), (2560, 5120), (8960, 2560), (2560, 8960)])
def test_int8_kernel_exact_at_the_recurrent_shapes(dev, m, n, k):
    g = torch.Generator(device=dev)
    g.manual_seed(m + n + k)
    a = pack_signs_int8(torch.randn(m, k, generator=g, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=g, device=dev))
    before = int8_matmul.launches
    got = int8_matmul(a, pw)
    torch.cuda.synchronize()
    assert int8_matmul.launches == before + 1
    assert torch.equal(got, int8_matmul_plain(a, pw))


def _counts() -> dict:
    return {fn.__name__: fn.launches for fn in COUNTED}


def _delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


@pytest.mark.parametrize("arch,kv", [("zamba2-2.7b", "auto"), ("zamba2-2.7b", "int8"),
                                     ("rwkv6-3b", "auto")])
def test_recurrent_smoke_model_on_card_matches_cpu(dev, arch, kv):
    cfg = smoke_config(arch).replace(kv_cache=kv, **F32)
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    params_dev = tree_map(lambda t: t.to(dev), params)
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    n_shared = cfg.n_layers // cfg.attn_every if cfg.family == "mamba2_hybrid" else 0
    tol = 1e-4 if cfg.family == "mamba2_hybrid" else 2 ** -7
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (3, 40)).astype(np.int32)
    before = _counts()
    got, caches_dev = api.prefill(params_dev, {"tokens": torch.from_numpy(toks).to(dev)},
                                  max_len=48)
    want_prefill = {"int8_matmul": 2 * n_binary, "flash_attention": n_shared}
    if kv == "int8":
        want_prefill["kv_quant_int8"] = n_shared
    assert _delta(before) == {k: v for k, v in want_prefill.items() if v}
    want, caches = api.prefill(params, {"tokens": torch.from_numpy(toks)}, max_len=48)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=tol * float(want.abs().max()))
    for _ in range(2):
        nxt = want.argmax(-1)[:, None]
        before = _counts()
        got, caches_dev = api.decode(params_dev, caches_dev, nxt.to(dev))
        want_step = {"int8_matmul": 2 * n_binary}
        if kv == "int8":
            want_step.update(kv_quant_int8=n_shared, kv_decode_int8=n_shared)
        assert _delta(before) == want_step
        want, caches = api.decode(params, caches, nxt)
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=tol * float(want.abs().max()))
