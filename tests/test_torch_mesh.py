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
* The MLA and MoE families (minicpm3-4b, deepseek-v2-236b,
  deepseek-v3-671b) at their smoke configs in f32 (deepseek at
  capacity_factor 16, as tests/test_torch_mla.py runs it): engine tokens
  equal the single device's, the whole compressed pool on every rank
  (kv_bytes_per_device == kv_bytes), deepseek-v2's tokens equal repro's
  ServeEngine's directly, and a MoE layer's routed output over a rank's
  experts (binary and float) equals one device's exactly (tolerance 0:
  each pair row is one rank's, so the sum over the ranks adds zeros).
* The launcher: --mesh 2 --device cpu (gloo) gives --mesh 0's tokens
  (zamba2-2.7b's too, through the bucket engine); --backend nccl refuses
  more ranks than cards; --spec-decode and --http refuse a mesh, whisper
  and the VLM the launcher (they need audio / image inputs).

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
TP_ARCHS = ("minicpm3-4b", "deepseek-v2-236b", "deepseek-v3-671b")
REPRO_ARCH = "deepseek-v2-236b"
MOE_ARCH, MOE_X = "deepseek-v2-236b", (2, 6)     # its blocks 1 (binary) and 2 (float) are MoE


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


def _family_cfg(arch):
    kw = dict(compute_dtype="float32", param_dtype="float32")
    if smoke_config(arch).n_experts:
        kw["capacity_factor"] = 16.0
    return smoke_config(arch).replace(**kw)


def _routed(fam, tp=None) -> dict:
    """{block: the routed output of each MoE block of MOE_ARCH} (shared
    experts left out), on this rank's shard where ``tp`` splits."""
    from repro_torch.models import moe
    cfg, params = fam[MOE_ARCH]
    if tp is not None:
        params = S.shard_params(get_model(cfg), params, make_mesh((tp.size,), ("model",)), tp,
                                S.serving_plan(cfg, make_mesh((tp.size,), ("model",)))[1])
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((*MOE_X, cfg.d_model)),
                        dtype=torch.float32)
    out = {}
    for i in range(cfg.first_dense_layers, cfg.n_layers):
        p = {k: v for k, v in params["blocks"][i]["ffn"].items() if k != "shared"}
        with tensor_parallel(tp):
            out[i] = moe.moe_apply(p, x, cfg)[0].numpy()
    return out


def _ranks(rank, world, lm, binary, fam):
    """One rank: every cell on the trained LM, the bucket engine, the
    binary smoke config's FFN and tokens, and the MLA / MoE families'
    tokens and routed MoE outputs."""
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
    out["families"] = {arch: _serve(get_model(cfg), params, _prompts(cfg.vocab)["plain"], mesh)
                       for arch, (cfg, params) in fam.items()}
    out["routed"] = _routed(fam, S.mesh_tensor_parallel(fam[MOE_ARCH][0], mesh)[0])
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
def repro_family():
    """REPRO_ARCH's (cfg, api, params) in repro, f32, as _family_cfg."""
    import jax

    from repro.configs import smoke_config as j_smoke
    from repro.models import get_model as j_get_model
    cfg = _family_cfg(REPRO_ARCH)
    jcfg = j_smoke(REPRO_ARCH).replace(compute_dtype="float32", param_dtype="float32",
                                       capacity_factor=cfg.capacity_factor)
    japi = j_get_model(jcfg)
    return jcfg, japi, jax.jit(japi.init)(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def families(repro_family):
    """{arch: (cfg, params)}: REPRO_ARCH on repro's params, the rest on
    the port's init."""
    import jax

    from repro_torch.models.convert import params_from_jax
    out = {}
    for arch in TP_ARCHS:
        cfg = _family_cfg(arch)
        if arch == REPRO_ARCH:
            params = params_from_jax(jax.tree.map(np.asarray, repro_family[2]), cfg,
                                     device="cpu")
        else:
            params = get_model(cfg).init(0, device="cpu")
        out[arch] = (cfg, params)
    return out


@pytest.fixture(scope="module")
def single(lms, families):
    (cfg, params), (bcfg, bparams) = lms
    api, prompts = get_model(cfg), _prompts(cfg.vocab)
    return {"cells": {name: _serve(api, params, prompts[which], **kw)
                      for name, kw, which in CELLS},
            "bucket": _bucket(api, params, prompts["plain"]),
            "binary_tokens": _serve(get_model(bcfg), bparams, prompts["plain"],
                                    kv_cache="int8")[0],
            "families": {arch: _serve(get_model(fcfg), fparams, _prompts(fcfg.vocab)["plain"])
                         for arch, (fcfg, fparams) in families.items()},
            "routed": _routed(families)}


@pytest.fixture(scope="module")
def runs(lms, families):
    return {n: spawn(_ranks, n, backend="gloo", args=(*lms, families), timeout=240)
            for n in WORLDS}


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
def test_mesh_mla_moe_tokens_and_whole_pool(runs, single, world):
    for rank_out in runs[world]:
        for arch in TP_ARCHS:
            got, want = rank_out["families"][arch], single["families"][arch]
            assert got[0] == want[0], (world, arch)
            assert all(len(o) == 6 for o in got[0])
            # MLA's compressed cache is whole on every rank
            assert got[1] == got[2] == want[1] == want[2], (world, arch)


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_moe_routed_output_exact(runs, single, world):
    want = single["routed"]
    assert len(want) == 2
    for rank_out in runs[world]:
        for i, y in rank_out["routed"].items():
            assert y.dtype == np.float32 and np.array_equal(y, want[i]), (world, i)


def test_mesh_mla_moe_cell_equals_repro(repro_family, runs):
    """REPRO_ARCH's mesh tokens held to repro's single-device ServeEngine."""
    from repro.serving import ServeEngine as JaxEngine
    jcfg, japi, jparams = repro_family
    eng = JaxEngine(japi, jparams, **ENGINE)
    rids = [eng.add_request(p, max_new=6) for p in _prompts(jcfg.vocab)["plain"]]
    res = eng.run()
    want = [res[r] for r in rids]
    for world in WORLDS:
        assert runs[world][0]["families"][REPRO_ARCH][0] == want, world


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
    for extra in (["--spec-decode", "2"], ["--http", "0"]):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            serve.main(LAUNCH + ["--mesh", "2"] + extra)
    # whisper and the VLM need audio / image inputs: refused before any rank
    for arch in ("whisper-base", "llama-3.2-vision-11b"):
        with pytest.raises(SystemExit):
            serve.main(LAUNCH + ["--mesh", "2", "--arch", arch])


def test_launcher_mesh_serves_zamba2_as_one_device():
    """--arch zamba2-2.7b --smoke --mesh 2 --device cpu: the bucket engine
    on two gloo ranks gives --mesh 0's tokens."""
    argv = ["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu", "--requests", "3",
            "--prompt-lens", "5,9", "--max-new", "3"]
    want = serve.main(argv + ["--mesh", "0"])
    assert serve.main(argv + ["--mesh", "2"]) == want
    assert sorted(want) == [0, 1, 2] and all(len(v) == 3 for v in want.values())
