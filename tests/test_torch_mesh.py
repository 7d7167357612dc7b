"""Tensor-parallel serving on the CPU: gloo ranks in spawned processes
(launch/mesh.spawn), one spawn per world size (2 and 4), on
``trained_lm`` (tests/conftest.py's fixture: f32, float FFNs), converted.

* ServeEngine(mesh=) tokens equal the single-device engine's on bf16 and
  int8, contiguous and paged, and on a sampled binary-pool cell and a paged
  int8 cell with the prefix cache and chunked prefill; the port's
  single-device engine stands in for repro, but one cell (int8 paged) is
  held to repro's ServeEngine directly. Every rank gets the same tokens.
* kv_bytes_per_device x N == kv_bytes in every cell.
* On the binary smoke config (bf16, random weights) a split binary FFN
  equals the single device's bit for bit in each binary mode (bin_out's
  integer dot is summed before the cast), and its engine tokens equal the
  single device's.
* BucketEngine(mesh=) tokens equal its single-device tokens.
* The launcher: --mesh 2 --device cpu (gloo) gives --mesh 0's tokens;
  --backend nccl refuses more ranks than cards; --spec-decode, --http and
  an arch outside the GQA dense family refuse a mesh.

Repro's own mesh engine is not run here: tests/test_engine_parity.py runs
it. Each rank runs one thread and its process group's timeout bounds it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.distributed.sharding import tensor_parallel  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn  # noqa: E402
from repro_torch.models import get_model, lm_common as lc  # noqa: E402
from repro_torch.serving.bucket import BucketEngine  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

WORLDS = (2, 4)
ENGINE = dict(max_batch=2, max_len=64, seed=11)
# (cell, ServeEngine options, prompts)
CELLS = [("bf16", dict(kv_cache="bf16"), "plain"),
         ("bf16 paged", dict(kv_cache="bf16", kv_block_size=8), "plain"),
         ("int8", dict(kv_cache="int8"), "plain"),
         ("int8 paged", dict(kv_cache="int8", kv_block_size=8), "plain"),
         ("binary sampled", dict(kv_cache="binary", temperature=0.8), "plain"),
         ("int8 paged prefix chunk 8", dict(kv_cache="int8", kv_block_size=8,
                                            prefix_cache=True, prefill_chunk=8), "shared")]
REPRO_CELL = "int8 paged"


def _markov(start, n, vocab):
    out, x = [], start
    for _ in range(n):
        out.append(x)
        x = (x * 7 + 13) % vocab
    return np.asarray(out, np.int32)


def _prompts(vocab) -> dict:
    plain = [_markov(3 + i, 7 + (i % 4), vocab) for i in range(5)]
    header = _markov(50, 16, vocab)
    return {"plain": plain,
            "shared": [np.concatenate([header, _markov(int(header[-1]) * 7 % vocab, 3 + i,
                                                       vocab)]) for i in range(5)]}


def _serve(api, params, prompts, mesh=None, **kw):
    eng = ServeEngine(api, params, mesh=mesh, **ENGINE, **kw)
    rids = [eng.add_request(p, max_new=6) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids], eng.stats["kv_bytes"], eng.stats["kv_bytes_per_device"]


def _bucket(api, params, prompts, mesh=None):
    eng = BucketEngine(api, params, max_batch=2, max_len=64, mesh=mesh)
    rids = [eng.add_request(p, max_new=6) for p in prompts]
    res = eng.run()
    return [res[r] for r in rids]


def _binary_ffn_inputs(cfg):
    rng = np.random.default_rng(5)
    return torch.as_tensor(rng.standard_normal((2, 5, cfg.d_model)),
                           dtype=torch.float32).to(torch.bfloat16)


def _ranks(rank, world, lm, binary):
    """One rank: every cell on the trained LM, the bucket engine, and the
    binary smoke config's FFN and tokens."""
    torch.set_num_threads(1)
    mesh = make_mesh((world,), ("model",))
    cfg, params = lm
    api = get_model(cfg)
    prompts = _prompts(cfg.vocab)
    out = {"cells": {name: _serve(api, params, prompts[which], mesh, **kw)
                     for name, kw, which in CELLS},
           "bucket": _bucket(api, params, prompts["plain"], mesh)}
    bcfg, bparams = binary
    bapi = get_model(bcfg)
    tp, rules = S.mesh_tensor_parallel(bcfg, mesh)
    local = S.shard_params(bapi, bparams, mesh, tp, rules)
    x = _binary_ffn_inputs(bcfg)
    i = next(j for j in range(bcfg.n_layers) if lc.block_sig(bcfg, j).ffn == "binary")
    out["ffn"] = {}
    for mode in ("int8", "xnor", "bf16"):
        mcfg = bcfg.replace(policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                                                   binary_mode=mode))
        with tensor_parallel(tp):
            y = lc.ffn_apply(local["blocks"][i]["ffn"], x, mcfg)
        # numpy across the process boundary: the bf16 bits as int16
        out["ffn"][mode] = (str(y.dtype), y.view(torch.int16).numpy())
    out["binary_tokens"] = _serve(bapi, bparams, prompts["plain"], mesh, kv_cache="int8")[0]
    return out


@pytest.fixture(scope="module")
def lms(trained_lm):
    import jax

    from repro_torch.models.convert import params_from_jax
    jcfg, _, jparams = trained_lm
    cfg = smoke_config("stablelm-3b").replace(policy=PrecisionPolicy(), compute_dtype="float32",
                                              param_dtype="float32")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    bcfg = smoke_config("stablelm-3b")
    assert bcfg.policy.binary_ffn and bcfg.compute_dtype == "bfloat16"
    return (cfg, params), (bcfg, get_model(bcfg).init(0, device="cpu"))


@pytest.fixture(scope="module")
def single(lms):
    (cfg, params), (bcfg, bparams) = lms
    api, prompts = get_model(cfg), _prompts(cfg.vocab)
    return {"cells": {name: _serve(api, params, prompts[which], **kw)
                      for name, kw, which in CELLS},
            "bucket": _bucket(api, params, prompts["plain"]),
            "binary_tokens": _serve(get_model(bcfg), bparams, prompts["plain"],
                                    kv_cache="int8")[0]}


@pytest.fixture(scope="module")
def runs(lms):
    return {n: spawn(_ranks, n, backend="gloo", args=lms, timeout=240) for n in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_tokens_equal_single_device(runs, single, world):
    for rank_out in runs[world]:
        for name, _, _ in CELLS:
            got, want = rank_out["cells"][name][0], single["cells"][name][0]
            assert got == want, (world, name)
            assert all(len(o) == 6 for o in got)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_kv_bytes_per_device(runs, single, world):
    for rank_out in runs[world]:
        for name, _, _ in CELLS:
            _, kv_bytes, per_device = rank_out["cells"][name]
            assert kv_bytes == single["cells"][name][1] == single["cells"][name][2]
            assert per_device * world == kv_bytes, (world, name)


def test_mesh_cell_equals_repro(trained_lm, runs):
    """One cell held to repro's single-device ServeEngine directly."""
    from repro.serving import ServeEngine as JaxEngine
    jcfg, japi, jparams = trained_lm
    kw = dict(next(kw for name, kw, _ in CELLS if name == REPRO_CELL))
    eng = JaxEngine(japi, jparams, **ENGINE, **kw)
    rids = [eng.add_request(p, max_new=6) for p in _prompts(jcfg.vocab)["plain"]]
    res = eng.run()
    want = [res[r] for r in rids]
    for world in WORLDS:
        assert runs[world][0]["cells"][REPRO_CELL][0] == want, world


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_binary_ffn_bit_for_bit(lms, runs, single, world):
    _, (bcfg, bparams) = lms
    x = _binary_ffn_inputs(bcfg)
    i = next(j for j in range(bcfg.n_layers) if lc.block_sig(bcfg, j).ffn == "binary")
    for mode, got in runs[world][0]["ffn"].items():
        mcfg = bcfg.replace(policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                                                   binary_mode=mode))
        want = lc.ffn_apply(bparams["blocks"][i]["ffn"], x, mcfg)
        assert got[0] == "torch.bfloat16", got[0]
        assert np.array_equal(got[1], want.view(torch.int16).numpy()), (world, mode)
        for other in runs[world][1:]:
            assert np.array_equal(other["ffn"][mode][1], got[1])
    for rank_out in runs[world]:
        assert rank_out["binary_tokens"] == single["binary_tokens"], world


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_bucket_engine(runs, single, world):
    for rank_out in runs[world]:
        assert rank_out["bucket"] == single["bucket"], world


LAUNCH = ["--smoke", "--device", "cpu", "--requests", "4", "--prompt-lens", "5,9,16",
          "--max-new", "4"]


def test_launcher_mesh_gloo_equals_single(tmp_path):
    """The repro launcher's own mesh example, --prefill-chunk with --mesh 2,
    over gloo on the CPU; rank 0 writes --metrics-out."""
    import json
    base = LAUNCH + ["--kv-cache", "int8", "--prefill-chunk", "8"]
    want = serve.main(base + ["--mesh", "0"])
    metrics = tmp_path / "m.json"
    assert serve.main(base + ["--mesh", "2", "--metrics-out", str(metrics)]) == want
    assert sorted(want) == [0, 1, 2, 3] and all(len(v) == 4 for v in want.values())
    assert json.loads(metrics.read_text())["counters"]["serve_tokens_total"] == 16


def test_launcher_mesh_refusals():
    with pytest.raises(RuntimeError, match="nccl takes one card per rank"):
        serve.main(LAUNCH + ["--mesh", "2", "--backend", "nccl"])
    for extra in (["--spec-decode", "2"], ["--http", "0"], ["--arch", "minicpm3-4b"],
                  ["--arch", "zamba2-2.7b"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            serve.main(LAUNCH + ["--mesh", "2"] + extra)
