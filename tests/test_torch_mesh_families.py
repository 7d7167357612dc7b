"""Tensor-parallel serving of the recurrent families, whisper and the VLM on
the CPU: gloo ranks in spawned processes (launch/mesh.spawn), one spawn per
world size (2 and 4), the smoke configs in f32.

* zamba2-2.7b (bf16 and int8 pools) and rwkv6-3b: BucketEngine(mesh=)
  tokens equal the single-device engine's on every rank; those run on
  repro's params (converted), and the int8 zamba2 cell and the rwkv6 cell
  equal repro's BucketEngine directly.
* whisper-base (a variant with a binary decoder FFN: the smoke config has
  none) and llama-3.2-vision-11b: a prefill and greedy decode steps give
  one device's tokens, their logits within 1e-5 of the max-abs.
* A rank's recurrent state after a prefill (Mamba2's ``h`` and ``conv``,
  RWKV6's ``tm_s``) equals its heads' slice of one device's within 1e-6:
  its heads of ``h`` / ``tm_s``, its x channels of ``conv`` beside B and C
  whole; the token-shift rows whole.
* A split binary layer equals one device's bit for bit: Mamba2's ``out``,
  RWKV6's channel-mix (c_v's int32 dot summed before its cast), whisper's
  and the VLM's binary FFN.
* At 4 ranks zamba2's 2 smoke Mamba heads and the VLM's 2 KV heads do not
  split: the mixer / attention run whole on every rank (their leaves and
  states whole) while the FFNs split; at 2 every part splits.
* kv_pool_bytes_per_device of the whole cache = the bytes of the cache a
  rank builds, for every family.
* RWKV6 with float FFNs at 4 blocks departs from one device only through
  c_v's row-parallel partial sums: applied whole (its input gathered), the
  mesh's logits are one device's bit for bit, and at 2 ranks the mesh as
  served equals one device that sums c_v's two partials as the mesh does
  (tools/rwkv6_split_rounding.py measures the same at full width).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import PrecisionPolicy  # noqa: E402
from repro_torch.distributed.sharding import scoped_api, tensor_parallel  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_mesh, spawn  # noqa: E402
from repro_torch.models import get_model, lm_common as lc, mamba2, rwkv6  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402
from repro_torch.serving.bucket import BucketEngine  # noqa: E402
from repro_torch.tree import tree_leaves_with_path  # noqa: E402

WORLDS = (2, 4)
F32 = dict(compute_dtype="float32", param_dtype="float32")
RECURRENT = ("zamba2-2.7b", "rwkv6-3b")
ENCDEC = ("whisper-base", "llama-3.2-vision-11b")
# (cell, arch, BucketEngine kv_cache)
BUCKET_CELLS = [("zamba2 bf16", "zamba2-2.7b", "bf16"), ("zamba2 int8", "zamba2-2.7b", "int8"),
                ("rwkv6", "rwkv6-3b", None)]
REPRO_CELLS = ("zamba2 int8", "rwkv6")
BUCKET = dict(max_batch=2, max_len=32)
STEPS, STATE_TOL, LOGITS_TOL = 4, 1e-6, 1e-5


def _cfg(arch):
    cfg = smoke_config(arch).replace(**F32)
    if arch == "whisper-base":
        # three decoder blocks, the middle one binary
        cfg = cfg.replace(n_layers=3, policy=PrecisionPolicy(binary_ffn=True, edge_blocks_float=1,
                                                             binary_mode="int8"))
    return cfg


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n) for n in (5, 9, 5, 12, 9)], [3, 5, 2, 4, 3]


def _batch(cfg):
    rng = np.random.default_rng(1)
    b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (2, 9)))}
    if cfg.family == "whisper":
        b["frames"] = torch.as_tensor(rng.standard_normal((2, cfg.n_audio_frames, cfg.d_model)),
                                      dtype=torch.float32)
    if cfg.family == "vlm":
        b["patches"] = torch.as_tensor(rng.standard_normal((2, cfg.n_patches, cfg.d_model)),
                                       dtype=torch.float32)
    return b


def _bucket(api, params, mesh=None, kv_cache=None):
    eng = BucketEngine(api, params, mesh=mesh, kv_cache=kv_cache, **BUCKET)
    prompts, max_news = _prompts(api.cfg.vocab)
    rids = [eng.add_request(p, max_new=n) for p, n in zip(prompts, max_news)]
    res = eng.run()
    return [res[r] for r in rids]


def _greedy(api, params, batch):
    """A prefill and STEPS greedy decodes -> (tokens, [logits]) as numpy."""
    logits, caches = api.prefill(params, batch, max_len=16)
    outs, toks = [logits.numpy().copy()], []
    for _ in range(STEPS):
        tok = logits.argmax(-1)[:, None]
        toks.append(tok[:, 0].numpy().copy())
        logits, caches = api.decode(params, caches, tok)
        outs.append(logits.numpy().copy())
    return np.stack(toks, 1), outs


def _states(api, params, cfg):
    """The recurrent leaves of the caches after a prefill -> {path: numpy}."""
    _, caches = api.prefill(params, {"tokens": _batch(cfg)["tokens"]}, max_len=16)
    return {p: t.numpy().copy() for p, t in tree_leaves_with_path(caches)
            if p.rsplit("/", 1)[-1] in ("h", "conv", "tm_s", "tm_x", "cm_x")}


def _binary_input(cfg, width, rng_seed=5):
    rng = np.random.default_rng(rng_seed)
    return torch.as_tensor(rng.standard_normal((2, 5, width)), dtype=torch.float32)


def _first_binary(cfg):
    return next(i for i in range(cfg.n_layers) if cfg.policy.block_is_binary(i, cfg.n_layers))


def _binary_layers(models, tp=None, mesh=None) -> dict:
    """Each family's split binary layer on a fixed input -> numpy (the f32
    bits): Mamba2's out on the rank's columns of y, RWKV6's channel-mix,
    whisper's and the VLM's binary FFN."""
    out = {}
    for arch, (cfg, params) in models.items():
        if tp is not None:
            api = get_model(cfg)
            ptp, rules = S.mesh_tensor_parallel(cfg, mesh)
            params = S.shard_params(api, params, mesh, ptp, rules)
            scope = tensor_parallel(ptp)
        else:
            scope = tensor_parallel(None)
        i = _first_binary(cfg)
        with scope as t:
            if arch == "zamba2-2.7b":
                y = _binary_input(cfg, cfg.expand * cfg.d_model)
                if t is not None and t.mixer:
                    n = y.shape[-1] // t.size
                    y = y[..., t.rank * n:(t.rank + 1) * n].contiguous()
                got = mamba2.out_proj(params["blocks"][i], y, cfg)
            elif arch == "rwkv6-3b":
                x = _binary_input(cfg, cfg.d_model)
                got = rwkv6.channel_mix(params["blocks"][i], x, cfg, x[:, :1])[0]
            else:
                blocks = params["dec_blocks" if arch == "whisper-base" else "blocks"]
                got = lc.ffn_apply(blocks[i]["ffn"], _binary_input(cfg, cfg.d_model), cfg)
        out[arch] = got.numpy().copy()
    return out


def _witness_cfg():
    """RWKV6 in f32 with float FFNs, 4 blocks: its bf16 time-mix turns
    c_v's f32 sum order into rounding flips a block later."""
    return smoke_config("rwkv6-3b").replace(n_layers=4, policy=PrecisionPolicy(), **F32)


def _split_c_v(world):
    """One device's c_v as ``world`` ranks' partial products summed in f32,
    rank order."""
    def c_v(p, k, cfg):
        w, n = p["c_v"]["w"], k.shape[-1] // world
        return sum(k[..., r * n:(r + 1) * n] @ w[r * n:(r + 1) * n] for r in range(world))
    return c_v


def _c_v_witness(mesh):
    """This rank's f32 logits of _witness_cfg as served and with c_v
    applied whole (its input gathered exactly, the whole weight)."""
    cfg = _witness_cfg()
    api = get_model(cfg)
    params = api.init(0, device="cpu")
    tp, rules = S.mesh_tensor_parallel(cfg, mesh)
    local = S.shard_params(api, params, mesh, tp, rules)
    whole = {id(lb): wb["c_v"] for lb, wb in zip(local["blocks"], params["blocks"])}
    sapi, batch = scoped_api(api, tp), {"tokens": _batch(cfg)["tokens"]}
    served = sapi.prefill(local, batch, max_len=16)[0].numpy().copy()
    c_v = rwkv6.c_v
    rwkv6.c_v = lambda p, k, cfg: rwkv6._dense_or_bin(whole[id(p)],
                                                      lc.split_tp("ffn").gather_last(k), cfg)
    try:
        gathered = sapi.prefill(local, batch, max_len=16)[0].numpy().copy()
    finally:
        rwkv6.c_v = c_v
    return served, gathered


def _ranks(rank, world, models):
    torch.set_num_threads(1)
    mesh = make_mesh((world,), ("model",))
    out = {"bucket": {}, "states": {}, "encdec": {}, "split": {}, "bytes": {}, "shapes": {}}
    for cell, arch, kv in BUCKET_CELLS:
        cfg, params = models[arch]
        out["bucket"][cell] = _bucket(get_model(cfg), params, mesh, kv)
    for arch, (cfg, params) in models.items():
        api = get_model(cfg)
        tp, rules = S.mesh_tensor_parallel(cfg, mesh)
        local = S.shard_params(api, params, mesh, tp, rules)
        sapi = scoped_api(api, tp)
        out["split"][arch] = dict(attn=tp.attn, ffn=tp.ffn, vocab=tp.vocab, mixer=tp.mixer)
        if arch in RECURRENT:
            out["states"][arch] = _states(sapi, local, cfg)
            out["shapes"][arch] = {p: tuple(t.shape) for p, t in tree_leaves_with_path(local)
                                   if "blocks/0/" in p}
        else:
            out["encdec"][arch] = _greedy(sapi, local, _batch(cfg))
        whole = api.init_cache(2, 16, "meta")
        out["bytes"][arch] = (kvc.kv_pool_bytes(sapi.init_cache(2, 16, "cpu")),
                              kvc.kv_pool_bytes_per_device(whole, mesh, rules),
                              kvc.kv_pool_bytes(whole))
    out["binary"] = _binary_layers(models, tp=True, mesh=mesh)
    out["c_v_witness"] = _c_v_witness(mesh)
    return out


@pytest.fixture(scope="module")
def repro_models():
    """zamba2 and rwkv6: repro's smoke models in f32, jitted init."""
    import jax

    from repro.configs import smoke_config as j_smoke
    from repro.models import get_model as j_get_model
    out = {}
    for arch in RECURRENT:
        japi = j_get_model(j_smoke(arch).replace(**F32))
        out[arch] = (japi, jax.jit(japi.init)(jax.random.PRNGKey(0)))
    return out


@pytest.fixture(scope="module")
def models(repro_models):
    """{arch: (cfg, params)}: the recurrent families on repro's params, the
    others on the port's init."""
    import jax

    from repro_torch.models.convert import params_from_jax
    out = {}
    for arch in RECURRENT:
        cfg = _cfg(arch)
        out[arch] = (cfg, params_from_jax(jax.tree.map(np.asarray, repro_models[arch][1]), cfg,
                                          device="cpu"))
    for arch in ENCDEC:
        cfg = _cfg(arch)
        out[arch] = (cfg, get_model(cfg).init(0, device="cpu"))
    return out


@pytest.fixture(scope="module")
def single(models):
    out = {"bucket": {cell: _bucket(get_model(models[arch][0]), models[arch][1], kv_cache=kv)
                      for cell, arch, kv in BUCKET_CELLS},
           "states": {arch: _states(get_model(models[arch][0]), models[arch][1], models[arch][0])
                      for arch in RECURRENT},
           "encdec": {arch: _greedy(get_model(models[arch][0]), models[arch][1],
                                    _batch(models[arch][0])) for arch in ENCDEC},
           "binary": _binary_layers(models)}
    return out


@pytest.fixture(scope="module")
def runs(models):
    return {n: spawn(_ranks, n, backend="gloo", args=(models,), timeout=240) for n in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_bucket_engine_tokens_equal_single_device(runs, single, world):
    for rank_out in runs[world]:
        for cell, _, _ in BUCKET_CELLS:
            got = rank_out["bucket"][cell]
            assert got == single["bucket"][cell], (world, cell)
            assert [len(o) for o in got] == _prompts(256)[1]


@pytest.mark.parametrize("cell", REPRO_CELLS)
def test_bucket_engine_cell_equals_repro(repro_models, runs, cell):
    """zamba2 on its int8 pool and rwkv6, held to repro's BucketEngine."""
    from repro.serving import BucketEngine as JaxBucketEngine
    arch, kv = next((a, k) for c, a, k in BUCKET_CELLS if c == cell)
    japi, jparams = repro_models[arch]
    eng = JaxBucketEngine(japi, jparams, kv_cache=kv, **BUCKET)
    prompts, max_news = _prompts(japi.cfg.vocab)
    rids = [eng.add_request(p, max_new=n) for p, n in zip(prompts, max_news)]
    res = eng.run()
    want = [res[r] for r in rids]
    for world in WORLDS:
        assert runs[world][0]["bucket"][cell] == want, world


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", ENCDEC)
def test_encdec_greedy_equals_single_device(runs, single, world, arch):
    want_toks, want_logits = single["encdec"][arch]
    for rank_out in runs[world]:
        toks, logits = rank_out["encdec"][arch]
        np.testing.assert_array_equal(toks, want_toks)
        for got, want in zip(logits, want_logits):
            assert np.abs(got - want).max() <= LOGITS_TOL * np.abs(want).max(), (world, arch)


def _state_slice(arch, path, want, world, rank, cfg, mixer):
    """One device's state leaf -> what rank ``rank`` holds of it."""
    name = path.rsplit("/", 1)[-1]
    if not mixer or name in ("tm_x", "cm_x"):
        return want
    if name in ("h", "tm_s"):
        n = want.shape[1] // world
        return want[:, rank * n:(rank + 1) * n]
    di = cfg.expand * cfg.d_model                          # conv: [x | B | C]
    n = di // world
    return np.concatenate([want[..., rank * n:(rank + 1) * n], want[..., di:]], axis=-1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", RECURRENT)
def test_rank_state_is_its_heads_slice(models, runs, single, world, arch):
    cfg = models[arch][0]
    want = single["states"][arch]
    for rank, rank_out in enumerate(runs[world]):
        got = rank_out["states"][arch]
        assert sorted(got) == sorted(want)
        mixer = rank_out["split"][arch]["mixer"]
        for path, w in want.items():
            w = _state_slice(arch, path, w, world, rank, cfg, mixer)
            assert got[path].shape == w.shape, (world, arch, path)
            assert np.abs(got[path] - w).max() <= STATE_TOL * max(np.abs(w).max(), 1e-30), \
                (world, arch, path)


@pytest.mark.parametrize("world", WORLDS)
def test_split_binary_layers_bit_for_bit(runs, single, world):
    for rank_out in runs[world]:
        for arch, want in single["binary"].items():
            got = rank_out["binary"][arch]
            assert got.dtype == np.float32 and np.array_equal(got, want), (world, arch)


@pytest.mark.parametrize("world", WORLDS)
def test_what_splits_and_what_replicates(models, runs, world):
    """At 2 ranks every part splits; at 4 zamba2's 2 Mamba heads (and so
    its shared block's heads, which mesh_rules_for ties to them) and the
    VLM's 2 KV heads keep their part whole while the FFNs and the vocab
    split."""
    split = runs[world][0]["split"]
    full = dict(ffn=True, vocab=True)
    assert split["zamba2-2.7b"] == dict(full, attn=world == 2, mixer=world == 2)
    assert split["rwkv6-3b"] == dict(full, attn=False, mixer=True)
    assert split["whisper-base"] == dict(full, attn=True, mixer=False)
    assert split["llama-3.2-vision-11b"] == dict(full, attn=world == 2, mixer=False)
    cfg = models["zamba2-2.7b"][0]
    di, d = cfg.expand * cfg.d_model, cfg.d_model
    shapes = runs[world][0]["shapes"]["zamba2-2.7b"]
    n = world if world == 2 else 1          # the mixer whole at 4
    assert shapes["blocks/0/in_zx/w"] == (d, 2 * di // n)
    assert shapes["blocks/0/conv_w"] == (cfg.d_conv, di // n + 2 * cfg.d_state)
    assert shapes["blocks/0/in_bcdt/w"] == (d, 2 * cfg.d_state + di // 64)
    assert shapes["blocks/0/a_log"] == (di // 64,)


@pytest.mark.parametrize("world", WORLDS)
def test_pool_bytes_per_device_are_what_a_rank_holds(runs, world):
    for rank_out in runs[world]:
        for arch, (held, per_device, whole) in rank_out["bytes"].items():
            assert held == per_device, (world, arch)
            split = rank_out["split"][arch]
            assert (per_device < whole) == (split["attn"] or split["mixer"]), (world, arch)


@pytest.mark.parametrize("world", WORLDS)
def test_rwkv6_mesh_departs_only_by_c_v_sum_order(runs, world, monkeypatch):
    cfg = _witness_cfg()
    api, batch = get_model(cfg), {"tokens": _batch(cfg)["tokens"]}
    params = api.init(0, device="cpu")
    whole = api.prefill(params, batch, max_len=16)[0].numpy()
    monkeypatch.setattr(rwkv6, "c_v", _split_c_v(world))
    split = api.prefill(params, batch, max_len=16)[0].numpy()
    for rank_out in runs[world]:
        served, gathered = rank_out["c_v_witness"]
        assert np.array_equal(gathered, whole), world
        if world == 2:         # gloo's order of four partials is its own
            assert np.array_equal(served, split)
