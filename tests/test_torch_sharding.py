"""The port's sharding rules (distributed/sharding.py, launch/specs.py, the
rule tables, serving/kvcache.cache_partition_specs) against repro's, with
stand-in meshes (axis names and sizes only, as tests/test_cache_sharding.py
uses): no process group, no second process.

* every config in ARCHS at full width, on `model` 2, `model` 4 and (`data`
  2, `model` 4), with and without fsdp: each param leaf's spec equals
  repro's partition_specs for its counterpart (repro's leading layer-stack
  entry dropped: the port keeps a list of layers), latent, and deployed
  for the dense and MoE families, which a mesh serves;
* mesh_rules_for gives repro's overrides, batch cells included;
* the cache rule covers test_cache_sharding's cases (every codec x pool,
  the 2-kv-head fallback at mesh 4, MLA latents replicated, prefill
  outputs), leaf for leaf equal to repro's, and the per-device bytes;
* the serving plan: what it splits (the MLA and MoE families too: heads,
  experts, shared experts; the recurrent families' mixers, whisper and
  the VLM), what it refuses, and each shard an allocation of its own;
  Mamba2's in_zx and conv cut by heads, B and C whole.
"""

import collections
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.distributed.sharding import partition_specs as jax_partition_specs  # noqa: E402
from repro.launch import specs as JS  # noqa: E402
from repro.models import get_model as jax_get_model  # noqa: E402
from repro.serving import kvcache as jkvc  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config, smoke_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.models import convert, get_model  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

FakeMesh = collections.namedtuple("FakeMesh", ["axis_names", "shape"])
MESHES = [FakeMesh(("model",), {"model": 2}), FakeMesh(("model",), {"model": 4}),
          FakeMesh(("data", "model"), {"data": 2, "model": 4})]
MESH2, MESH4 = MESHES[:2]


def _repro_flat(tree, is_leaf=None) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


@functools.lru_cache(maxsize=None)
def _stacks(cfg, decoder: bool) -> tuple[str, list]:
    """(repro's key prefix of a stacked segment, each segment's layers)."""
    if decoder:
        from repro_torch.models.whisper import _dec_segments
        return "seg", [c for _, c, _ in _dec_segments(cfg)]
    return convert._block_stacks(cfg)


def _repro_path(cfg, path: str) -> str:
    """The port's leaf path -> repro's: a layer i of a per-layer list is
    layer i - start of its stacked segment (``seg{s}`` / ``run{s}``);
    whisper's encoder and a VLM's cross blocks are one stack each."""
    parts = path.split("/")
    stacked = parts[0] in ("blocks", "dec_blocks") and len(parts) > 1 and parts[1].isdigit()
    if stacked or parts[0].isdigit():
        prefix, counts = _stacks(cfg, parts[0] == "dec_blocks")
        head, i = (parts[:1], int(parts[1])) if stacked else ([], int(parts[0]))
        s = 0
        while i >= counts[s]:
            i, s = i - counts[s], s + 1
        return "/".join(head + [f"{prefix}{s}"] + parts[(2 if stacked else 1):])
    if parts[0] in ("enc_blocks", "cross") and len(parts) > 1 and parts[1].isdigit():
        return "/".join(parts[:1] + parts[2:])
    return path


def _full(spec, ndim: int) -> tuple:
    return tuple(spec) + (None,) * (ndim - len(tuple(spec)))


def _assert_specs_match(cfg, port_tree, port_specs, repro_tree, repro_specs, what):
    jleaves = _repro_flat(repro_tree)
    jspecs = _repro_flat(repro_specs, is_leaf=lambda x: isinstance(x, P))
    ported = tree_leaves_with_path(port_tree)
    assert len(ported) == len(tree_leaves(port_specs))
    for (path, leaf), spec in zip(ported, tree_leaves(port_specs)):
        rp = _repro_path(cfg, path)
        assert rp in jleaves, (what, path, rp)
        nd = len(jleaves[rp].shape)
        assert _full(jspecs[rp], nd)[nd - leaf.ndim:] == _full(spec, leaf.ndim), \
            (what, path, spec, jspecs[rp])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_repro(arch):
    api, japi = get_model(get_config(arch)), jax_get_model(jax_get_config(arch))
    # the deployed trees (DEPLOYED_RULES first): a mesh serves every arch
    for deployed in (False, True):
        p_abs = S.abstract_params(api, deployed=deployed)
        jp = jax.eval_shape(lambda: japi.init_deployed(jax.random.PRNGKey(0)) if deployed
                            else japi.init(jax.random.PRNGKey(0)))
        rules = api.deployed_rules if deployed else api.param_rules
        jrules = japi.deployed_rules if deployed else japi.param_rules
        for fsdp in (False, True):
            cfg, jcfg = api.cfg.replace(fsdp=fsdp), japi.cfg.replace(fsdp=fsdp)
            for mesh in MESHES:
                mr, jmr = S.mesh_rules_for(cfg, mesh), JS.mesh_rules_for(jcfg, mesh)
                assert (mr.rules, mr.fsdp) == (jmr.rules, jmr.fsdp)
                _assert_specs_match(cfg, p_abs, shd.partition_specs(p_abs, rules, mesh, mr),
                                    jp, jax_partition_specs(jp, jrules, mesh, jmr),
                                    (arch, fsdp, deployed, mesh.shape))


RULE_MESHES = MESHES + [FakeMesh(("model",), {"model": 16}),
                        FakeMesh(("pod", "data", "model"), {"pod": 2, "data": 3, "model": 2})]


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_rules_for_equal_repro(arch):
    """Every override, the 40-head fallback at model 16 and batch
    divisibility over (pod, data) on each of repro's shape cells among
    them."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for mesh in RULE_MESHES:
        for name in [None, *SHAPES]:
            got = S.mesh_rules_for(cfg, mesh, SHAPES[name] if name else None)
            want = JS.mesh_rules_for(jcfg, mesh, JAX_SHAPES[name] if name else None)
            assert (got.rules, got.fsdp) == (want.rules, want.fsdp), (mesh, name)


def test_rwkv6_heads_replicate_at_model_16():
    # 40 heads do not split 16 ways: attention is replicated
    assert S.mesh_rules_for(get_config("rwkv6-3b"), RULE_MESHES[3]).rules["heads"] is None


def _port_pool(api, pool):
    if pool == "paged":
        return api.init_paged_cache(16, 8, 2, 8, device="cpu")
    return api.init_cache(2, 64, "cpu")


def _repro_pool(japi, pool):
    if pool == "paged":
        return jax.eval_shape(lambda: japi.init_paged_cache(16, 8, 2, 8))
    return jax.eval_shape(lambda: japi.init_cache(2, 64))


@pytest.mark.parametrize("codec", ["bf16", "int8", "binary"])
@pytest.mark.parametrize("pool", ["contiguous", "paged"])
def test_cache_specs_equal_repro(codec, pool):
    """Value leaves shard the head axis, scale leaves their last dim,
    len / table replicated; the same specs as repro's, leaf for leaf, and
    each device holds exactly 1 / N of kv_pool_bytes."""
    cfg = smoke_config("stablelm-3b").replace(kv_cache=codec)
    jcfg = jax_smoke_config("stablelm-3b").replace(kv_cache=codec)
    api, japi = get_model(cfg), jax_get_model(jcfg)
    caches, jcaches = _port_pool(api, pool), _repro_pool(japi, pool)
    for mesh in (MESH2, MESH4):
        rules = S.mesh_rules_for(cfg, mesh)
        specs = kvc.cache_partition_specs(caches, mesh, rules)
        _assert_specs_match(cfg, caches, specs, jcaches,
                            jkvc.cache_partition_specs(jcaches, mesh,
                                                       JS.mesh_rules_for(jcfg, mesh)),
                            (codec, pool))
        n = mesh.shape["model"]
        for path, spec in tree_leaves_with_path(specs):
            name = path.rsplit("/", 1)[-1]
            if name in kvc._KV_VALUE_LEAVES:
                assert spec[-2] == "model" and spec[-1] is None, (path, spec)
            elif name in kvc._KV_SCALE_LEAVES:
                assert spec[-1] == "model", (path, spec)
            else:
                assert spec == (), (path, spec)
        assert kvc.kv_pool_bytes_per_device(caches, mesh, rules) * n == kvc.kv_pool_bytes(caches)


def test_cache_two_kv_heads_replicate_at_mesh_4():
    # qwen3-8b smoke: 2 KV heads cannot split 4 ways, so every leaf is
    # replicated (the widest-divisible fallback), and so is the serving
    # plan's attention block
    cfg, jcfg = smoke_config("qwen3-8b"), jax_smoke_config("qwen3-8b")
    caches = get_model(cfg).init_cache(2, 64, "cpu")
    rules = S.mesh_rules_for(cfg, MESH4)
    specs = kvc.cache_partition_specs(caches, MESH4, rules)
    assert all(all(e is None for e in s) for s in tree_leaves(specs))
    jcaches = _repro_pool(jax_get_model(jcfg), "contiguous")
    _assert_specs_match(cfg, caches, specs, jcaches, jkvc.cache_partition_specs(
        jcaches, MESH4, JS.mesh_rules_for(jcfg, MESH4)), "qwen3 mesh 4")
    assert kvc.kv_pool_bytes_per_device(caches, MESH4, rules) == kvc.kv_pool_bytes(caches)
    tp, _ = S.serving_plan(cfg, MESH4)
    assert (tp.attn, tp.ffn, tp.vocab) == (False, True, True)


def test_cache_mla_latents_replicate():
    cfg, jcfg = smoke_config("deepseek-v3-671b"), jax_smoke_config("deepseek-v3-671b")
    assert cfg.use_mla
    caches = get_model(cfg).init_cache(2, 64, "cpu")
    specs = kvc.cache_partition_specs(caches, MESH2, S.mesh_rules_for(cfg, MESH2))
    assert specs and all(s == () for s in tree_leaves(specs))
    jcaches = _repro_pool(jax_get_model(jcfg), "contiguous")
    _assert_specs_match(cfg, caches, specs, jcaches, jkvc.cache_partition_specs(
        jcaches, MESH2, JS.mesh_rules_for(jcfg, MESH2)), "mla")


def test_cache_prefill_outputs_covered():
    # a prefill's transient caches (batch 4, max_len 128) take the same
    # name-driven spec: "model" on the head axis
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    _, caches = api.prefill(api.init(0, device="cpu"),
                            {"tokens": torch.zeros((4, 16), dtype=torch.int64)}, max_len=128)
    specs = kvc.cache_partition_specs(caches, MESH2, S.mesh_rules_for(cfg, MESH2))
    for path, spec in tree_leaves_with_path(specs):
        if path.rsplit("/", 1)[-1] in kvc._KV_VALUE_LEAVES:
            assert len(spec) >= 4 and spec[-2] == "model", (path, spec)


def test_input_specs_equal_repro():
    """input_specs, the batch, cache and decode-token specs: repro's shapes
    and dtypes, and the placements of their specs."""
    from torch.distributed.tensor import Replicate, Shard
    for arch, shape in (("stablelm-3b", "decode_32k"), ("whisper-base", "train_4k"),
                        ("llama-3.2-vision-11b", "prefill_32k")):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        got = S.input_specs(cfg, SHAPES[shape])
        want = JS.input_specs(jcfg, JAX_SHAPES[shape])
        assert sorted(got) == sorted(want)
        jcaches = _repro_flat(want.pop("caches", {}))
        for path, leaf in tree_leaves_with_path(got.pop("caches", {})):
            jleaf = jcaches[_repro_path(cfg, path)]
            assert tuple(leaf.shape) == jleaf.shape[len(jleaf.shape) - leaf.ndim:], path
            assert str(leaf.dtype).split(".")[-1] == str(jleaf.dtype), path
        for k in got:
            assert tuple(got[k].shape) == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
    mesh = MESHES[2]
    rules = S.mesh_rules_for(get_config("stablelm-3b"), mesh, SHAPES["train_4k"])
    specs, sh = S.batch_specs_and_shardings(get_config("stablelm-3b"), SHAPES["train_4k"],
                                            mesh, rules)
    assert sh["tokens"] == [Shard(0), Replicate()] and specs["tokens"].device.type == "meta"
    tok, tok_sh = S.decode_token_specs(None, SHAPES["decode_32k"], mesh, rules)
    assert tuple(tok.shape) == (128, 1) and tok_sh == [Shard(0), Replicate()]


def test_placements_and_param_shardings():
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES[2]
    assert shd.placements(("data", "model"), mesh) == [Shard(0), Shard(1)]
    assert shd.placements((None, "model"), mesh) == [Replicate(), Shard(1)]
    assert shd.placements((), mesh) == [Replicate(), Replicate()]
    api = get_model(smoke_config("stablelm-3b"))
    p_abs, p_sh = S.param_shardings(api, mesh, S.mesh_rules_for(api.cfg, mesh))
    assert p_sh["embed"]["table"] == [Replicate(), Shard(0)]
    assert p_sh["blocks"][0]["attn"]["wo"]["w"] == [Replicate(), Shard(0)]
    o_abs, o_sh = S.opt_shardings(api, api.cfg, p_abs, p_sh, mesh)
    assert o_sh["m"] is p_sh and tuple(o_abs["step"].shape) == ()


def test_serving_plan_and_shards():
    """What a `model` mesh splits for the GQA dense family, and each rank's
    shard: its own allocation (16-byte aligned, contiguous, not a view of
    the full tensor), the ranks' shards tiling the full leaf."""
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    tp, rules = S.serving_plan(cfg, MESH2)
    assert (tp.size, tp.attn, tp.ffn, tp.vocab) == (2, True, True, True)
    one, _ = S.serving_plan(cfg, FakeMesh(("model",), {"model": 1}))
    assert not (one.attn or one.ffn or one.vocab)
    shards = [S.shard_params(api, params, MESH2, shd.TensorParallel(2, r), rules)
              for r in range(2)]
    specs = shd.partition_specs(params, api.deployed_rules, MESH2, rules)
    for (path, full), spec, *parts in zip(tree_leaves_with_path(params), tree_leaves(specs),
                                          *(tree_leaves(s) for s in shards)):
        dims = [d for d, e in enumerate(spec) if e == "model"]
        if not dims:
            assert all(p is full for p in parts), path
            continue
        assert torch.equal(torch.cat(parts, dim=dims[0]), full), path
        for p in parts:
            assert p.is_contiguous() and p.data_ptr() % 16 == 0, path
            assert p.untyped_storage().data_ptr() != full.untyped_storage().data_ptr(), path
    # bin_out's shard holds whole packed words: K = d_ff / 2 = 64 = 2 words
    assert tuple(shards[0]["blocks"][1]["ffn"]["bin_out"]["w_packed"].shape) == (64, 2)


def test_serving_plan_refuses():
    cfg = smoke_config("stablelm-3b")
    # d_ff 128 over 8 ranks leaves 16 bits of bin_out's K a rank: no whole word
    with pytest.raises(ValueError, match="d_ff 128"):
        S.serving_plan(cfg, FakeMesh(("model",), {"model": 8}))
    # the recurrent families, whisper and the VLM are planned (ROADMAP A9
    # (f)): at full width on 2 ranks every part splits, the mixer where the
    # family has one; zamba2 at 32 ranks keeps its 80 Mamba heads whole
    # (and the shared block's heads, which mesh_rules_for ties to them)
    for arch, mixer in (("zamba2-2.7b", True), ("rwkv6-3b", True), ("whisper-base", False),
                        ("llama-3.2-vision-11b", False)):
        tp, rules = S.serving_plan(get_config(arch), MESH2)
        assert (tp.attn, tp.ffn, tp.vocab, tp.mixer) == (arch != "rwkv6-3b", True, True,
                                                          mixer), arch
    tp, rules = S.serving_plan(get_config("zamba2-2.7b"), FakeMesh(("model",), {"model": 32}))
    assert (tp.attn, tp.mixer, tp.ffn) == (False, False, True)
    assert rules.segments("blocks/3/in_zx/bin/w_packed") == ()
    # rwkv6 at 16 ranks: its 40 heads would run whole, but c_v's K = 8960 /
    # 16 is 17.5 words a rank
    with pytest.raises(ValueError, match="d_ff 8960 does not split into 16"):
        S.serving_plan(get_config("rwkv6-3b"), FakeMesh(("model",), {"model": 16}))
    # the VLM at 16 ranks: 8 KV heads, its attention whole
    tp, _ = S.serving_plan(get_config("llama-3.2-vision-11b"),
                           FakeMesh(("model",), {"model": 16}))
    assert (tp.attn, tp.ffn, tp.vocab) == (False, True, True)
    # the experts must divide: 8 smoke experts over 16 ranks (the smoke
    # widths at 16 ranks otherwise split: d_ff 512 is 32 bits a rank)
    moe = smoke_config("deepseek-v2-236b").replace(d_ff=512, n_heads=16, n_kv_heads=16,
                                                    vocab=4096)
    with pytest.raises(ValueError, match="n_experts 8 does not split into 16"):
        S.serving_plan(moe, FakeMesh(("model",), {"model": 16}))


def test_mamba_cut_takes_each_half_by_heads():
    """A rank's in_zx holds its heads' z columns and x columns (repro's
    contiguous cut would give rank 0 all of z), its conv channels its x
    channels beside B and C whole, in allocations of their own; the same
    cut sizes its conv state."""
    cfg = smoke_config("zamba2-2.7b")
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    tp, rules = S.serving_plan(cfg, MESH2)
    di, ds = cfg.expand * cfg.d_model, cfg.d_state
    assert tp.mixer and di == 128
    for r in range(2):
        local = S.shard_params(api, params, MESH2, shd.TensorParallel(2, r), rules)
        half = slice(r * 64, (r + 1) * 64)
        for i, blk in enumerate(params["blocks"]):
            mine = local["blocks"][i]
            zx = blk["in_zx"]["bin"] if "bin" in blk["in_zx"] else blk["in_zx"]
            got = mine["in_zx"]["bin"] if "bin" in mine["in_zx"] else mine["in_zx"]
            for name, dim in (("w_latent", 1), ("w", 1), ("scale", 0), ("w_packed", 0)):
                if name in zx:
                    want = torch.cat([zx[name].narrow(dim, half.start, 64),
                                      zx[name].narrow(dim, di + half.start, 64)], dim=dim)
                    assert torch.equal(got[name], want), (i, name)
                    assert got[name].is_contiguous() and got[name].data_ptr() % 16 == 0
            want = torch.cat([blk["conv_w"][:, half], blk["conv_w"][:, di:]], dim=1)
            assert torch.equal(mine["conv_w"], want) and mine["conv_w"].shape[1] == 64 + 2 * ds
            assert torch.equal(mine["in_bcdt"]["w"], blk["in_bcdt"]["w"])
            assert torch.equal(mine["gnorm"]["scale"], blk["gnorm"]["scale"][half])
    conv = torch.empty((2, cfg.d_conv - 1, di + 2 * ds), device="meta")
    assert shd.shard_shape(conv.shape, (None, None, "model"), MESH2,
                           rules.segments("mamba/0/conv")) == (2, 3, 64 + 2 * ds)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v2-236b", "deepseek-v3-671b"])
def test_serving_plan_splits_mla_and_moe(arch):
    """MLA splits by its heads alone (no KV-head axis: its compressed cache
    is replicated), a MoE layer's routed experts over `expert` and its
    shared experts as an FFN; at full width too. Each rank's shard of a
    split leaf is its own allocation, and the shards tile the leaf: a
    rank holds E / N whole experts and its heads' columns of w_uq / w_uk /
    w_uv."""
    cfg = smoke_config(arch)
    moe = bool(cfg.n_experts)
    for c in (cfg, get_config(arch)):
        tp, _ = S.serving_plan(c, MESH2)
        assert (tp.attn, tp.ffn, tp.vocab, tp.experts) == (True, True, True, moe), c.name
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    tp, rules = S.serving_plan(cfg, MESH4)
    specs = shd.partition_specs(params, api.deployed_rules, MESH4, rules)
    shards = [S.shard_params(api, params, MESH4, shd.TensorParallel(4, r), rules)
              for r in range(4)]
    split = {}
    for (path, full), spec, *parts in zip(tree_leaves_with_path(params), tree_leaves(specs),
                                          *(tree_leaves(s) for s in shards)):
        dims = [d for d, e in enumerate(spec) if e == "model"]
        split[path] = dims
        if not dims:
            assert all(p is full for p in parts), path
            continue
        assert torch.equal(torch.cat(parts, dim=dims[0]), full), path
        for p in parts:
            assert p.is_contiguous() and p.data_ptr() % 16 == 0, path
            assert p.untyped_storage().data_ptr() != full.untyped_storage().data_ptr(), path
    a = "blocks/1/attn/"
    assert [split[a + k + "/w"] for k in ("w_uq", "w_uk", "w_uv", "wo")] == [[1], [1], [1], [0]]
    assert all(split[a + k] == [] for k in ("w_dq/w", "w_dkv/w", "q_norm/scale",
                                            "kv_norm/scale"))
    if moe:
        f = "blocks/1/ffn/"
        assert [split[f + k] for k in ("w_gate", "w_up", "w_down", "s_mid", "s_out")] == \
            [[0]] * 5
        assert split[f + "router/w"] == [] and split[f + "shared/w_down/w"] == [0]
        assert tuple(shards[0]["blocks"][1]["ffn"]["w_gate"].shape)[0] == cfg.n_experts // 4
    with pytest.raises(ValueError, match="serves on a `model` mesh only"):
        S.serving_plan(cfg, MESHES[2])


def test_local_shard_tuple_axes_row_major():
    # a dim over (data, model) counts row-major, data outermost, as jax does
    mesh = MESHES[2]
    t = torch.arange(16.0).reshape(16, 1)
    got = [shd.local_shard(t, (("data", "model"), None), mesh, {"data": d, "model": m})
           for d in range(2) for m in range(4)]
    assert torch.equal(torch.cat(got), t)
    assert shd.shard_shape((16, 3), (("data", "model"), None), mesh) == (2, 3)
    assert np.array_equal(got[5].numpy()[:, 0], [10.0, 11.0])
