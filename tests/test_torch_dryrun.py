"""The dry run (launch/dryrun.py), its collective recorder
(distributed/collectives.py) and the perf runner (launch/perf.py) on the
CPU, on smoke configs and small MeshShapes, with no process group:

* a decode step's recorded all_reduces = the closed form of
  TensorParallel's call sites (one after each split attention and FFN a
  layer, the embedding and the logits where the vocab splits), and none
  over ``data``; an FFN whose shard would not hold whole packed words is
  refused by the plans, so its cell is skipped naming ROADMAP A9 (k);
* the roofline is one card's share: a part kept whole on the ``model``
  axis counts whole on every rank, as the rank's counted FLOPs show;
* DataParallel.mean's buckets and bytes = its MEAN_BUCKET rule;
* a rank's argument bytes = its shard shapes' sum = the bytes of the real
  trees (specs.shard_params / TrainPlan.shard, adamw_init, init_cache);
* flops_counted within 10% of the analytic count (dense smoke configs);
* the recurrent families, whisper and the VLM on a model axis: every
  part splits, the all_reduces are the call sites, the argument bytes the
  rank's real trees (Mamba2's cut by heads);
* the refusals recorded ``skipped`` with their ROADMAP items, long_500k
  with cell_is_runnable's reason, the CLI's records with repro's keys;
* perf.run_pair prints repro's table, one row a variant.

(tests/test_torch_train_mesh.py holds the recorder's counts to what real
gloo ranks issue.)
"""

import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.distributed import analytic_cost as AC  # noqa: E402
from repro_torch.distributed import collectives, hlo_analysis  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.sharding import tensor_parallel  # noqa: E402
from repro_torch.launch import dryrun, perf  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

torch.set_num_threads(2)

DENSE = ("stablelm-3b", "qwen3-8b", "qwen2-72b")
MESHES = ((1, 2), (2, 1), (2, 2))
DECODE = ShapeSpec("decode", 64, 4, "decode")
PREFILL = ShapeSpec("prefill", 32, 4, "prefill")
TRAIN = ShapeSpec("train", 32, 4, "train")
# repro/launch/dryrun.py's record keys (run_cell and analyze_compiled);
# the port has trace_s where repro has compile_s (no compile here)
REPRO_KEYS = {"arch", "shape", "mesh", "kind", "tag", "status", "n_chips", "lower_s",
              "model_flops_step", "useful_flops_ratio", "param_count", "param_count_active",
              "cost", "collectives", "memory", "analytic", "roofline"}
REPRO_COLLECTIVES = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                     "collective-permute", "total_bytes"}


def _mesh(dims):
    return MeshShape(dims, ("data", "model"))


def _cell(arch, shape, dims, cfg=None, **kw):
    cfg = cfg or smoke_config(arch)
    return dryrun.run_cell(arch, shape.name, cfg_override=cfg, shape=shape, mesh=_mesh(dims),
                           out_dir=None, **kw)


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@pytest.mark.parametrize("dims", MESHES)
@pytest.mark.parametrize("arch", DENSE)
def test_decode_all_reduces_are_the_call_sites(arch, dims):
    cfg = smoke_config(arch)
    rec = _cell(arch, DECODE, dims, cfg)
    assert rec["status"] == "ok"
    coll = rec["collectives"]
    tp = S.serving_plan(cfg, MeshShape((dims[1],), ("model",)))[0]
    want = cfg.n_layers * (tp.attn + tp.ffn) + 2 * tp.vocab
    split = dims[1] > 1
    assert (tp.attn, tp.ffn, tp.vocab) == (split,) * 3
    assert coll["all-reduce"]["count"] == want == split * (2 * cfg.n_layers + 2)
    assert set(coll["by_axis"]) == ({"model"} if split else set())
    # repro's ring factor: wire bytes = 2 x payload
    assert coll["all-reduce"]["bytes"] == 2 * coll["payload_bytes"] == coll["total_bytes"]
    assert rec["rows_per_card"] == DECODE.global_batch // dims[0]


def test_an_ffn_without_whole_words_a_shard_is_skipped_naming_the_roadmap():
    cfg = smoke_config("stablelm-3b").replace(d_ff=96)       # 48 a rank: 1.5 words
    for shape in (DECODE, TRAIN):
        rec = _cell("stablelm-3b", shape, (1, 2), cfg)
        assert rec["status"] == "skipped" and "d_ff 96" in rec["reason"]
        assert "ROADMAP A9 (k)" in rec["reason"]


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_qwen2_72b_over_8_is_skipped_by_its_plan(shape):
    # d_ff 29568 / 8 = 3696 = 115.5 words a rank: the plans refuse it
    # before anything is traced
    rec = dryrun.run_cell("qwen2-72b", shape, out_dir=None)
    assert rec["status"] == "skipped" and "d_ff 29568" in rec["reason"]
    assert "ROADMAP A9 (k)" in rec["reason"]


@pytest.mark.parametrize("shard_kv", [True, False], ids=["attn_split", "attn_whole"])
def test_roofline_counts_a_whole_part_on_every_rank(shard_kv):
    cfg = smoke_config("stablelm-3b").replace(shard_kv_heads=shard_kv)
    rec = _cell("stablelm-3b", PREFILL, (1, 2), cfg)
    assert rec["split"] == {"attn": shard_kv, "ffn": True, "vocab": True, "experts": False}
    total = AC.step_cost(cfg, PREFILL)
    rl = rec["roofline"]
    # the rank's counted products are its analytic share
    assert abs(rec["cost"]["flops_counted"] - rl["flops"]) <= 0.1 * rl["flops"]
    if shard_kv:
        assert rl["flops"] == total.flops_total / 2
        assert rl["hbm_bytes"] == total.hbm_bytes / 2
    else:
        assert rl["flops"] > total.flops_total / 2 and rl["hbm_bytes"] > total.hbm_bytes / 2


@pytest.mark.parametrize("arch", ["stablelm-3b", "qwen3-8b"])
def test_data_parallel_mean_buckets_follow_its_rule(arch, monkeypatch):
    cfg = smoke_config(arch)
    bucket = 5000
    monkeypatch.setattr(sharding, "MEAN_BUCKET", bucket)
    low = dryrun.lower_cell(arch, "train", cfg_override=cfg, shape=TRAIN,
                            mesh=_mesh((2, 1)))[0]
    numels = [math.prod(shape) for shape, _ in tree_leaves(low.params)]
    n_buckets, i = 0, 0
    while i < len(numels):
        n, i = numels[i], i + 1
        while i < len(numels) and n + numels[i] <= bucket:
            n, i = n + numels[i], i + 1
        n_buckets += 1
    assert n_buckets > 3
    api = get_model(cfg)
    metrics = api.loss(api.init(0, device="cpu", packed=False),
                       {k: torch.zeros((2, 8), dtype=torch.int32)
                        for k in ("tokens", "labels")})[1]
    rec = _cell(arch, TRAIN, (2, 1), cfg)
    data = rec["collectives"]["by_axis"]["data"]
    assert data["count"] == n_buckets + 1                       # + the metrics' mean
    assert data["payload_bytes"] == 4 * (sum(numels) + len(metrics))
    assert "model" not in rec["collectives"]["by_axis"]


@pytest.mark.parametrize("dims", MESHES)
def test_train_argument_bytes_are_the_shards(dims):
    cfg = smoke_config("qwen3-8b")
    api = get_model(cfg)
    low = dryrun.lower_cell("qwen3-8b", "train", cfg_override=cfg, shape=TRAIN,
                            mesh=_mesh(dims))[0]
    shards = sum(math.prod(s) * dt.itemsize for s, dt in tree_leaves(low.params))
    plan = S.train_plan(cfg, _mesh(dims), TRAIN)
    real = plan.shard(api, api.init(0, device="cpu", packed=False))
    mem = _cell("qwen3-8b", TRAIN, dims, cfg)["memory"]
    assert mem["params_bytes"] == shards == _nbytes(real)
    assert mem["opt_bytes"] == _nbytes(adamw_init(real))
    assert mem["batch_bytes"] == 2 * TRAIN.global_batch // dims[0] * TRAIN.seq_len * 4
    assert mem["argument_bytes"] == sum(mem[k] for k in ("params_bytes", "opt_bytes",
                                                         "batch_bytes"))
    assert mem["peak_bytes"] > mem["argument_bytes"]


@pytest.mark.parametrize("weights", ["packed", "deployed", "latent"])
def test_serving_argument_bytes_are_the_shards(weights):
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    model = MeshShape((2,), ("model",))
    tp, rules = S.serving_plan(cfg, model)
    full = (api.init_deployed(0, device="cpu") if weights == "deployed"
            else api.init(0, device="cpu", packed=weights == "packed"))
    real = S.shard_params(api, full, model, tp, rules)
    with tensor_parallel(tp):
        cache = api.init_cache(DECODE.global_batch, DECODE.seq_len, "cpu")
    mem = _cell("stablelm-3b", DECODE, (1, 2), cfg, weights=weights)["memory"]
    assert mem["params_bytes"] == _nbytes(real)
    assert mem["cache_bytes"] == _nbytes(cache)
    assert mem["batch_bytes"] == DECODE.global_batch * 4


def test_serving_weights_default_to_repro_choice():
    low = dryrun.lower_cell("stablelm-3b", "d", cfg_override=smoke_config("stablelm-3b"),
                            shape=DECODE, mesh=_mesh((1, 2)))[0]
    assert low.weights == "deployed"
    low = dryrun.lower_cell("stablelm-3b", "t", cfg_override=smoke_config("stablelm-3b"),
                            shape=TRAIN, mesh=_mesh((1, 2)))[0]
    assert low.weights == "latent"


@pytest.mark.parametrize("shape", [PREFILL, TRAIN], ids=["prefill", "train"])
@pytest.mark.parametrize("arch", DENSE)
def test_flops_counted_near_the_analytic_count(arch, shape):
    cfg = smoke_config(arch)
    rec = _cell(arch, shape, (1, 1), cfg)
    total = AC.step_cost(cfg, shape).flops_total
    assert abs(rec["cost"]["flops_counted"] - total) <= 0.1 * total
    a = rec["analytic"]
    assert a["flops_bf16"] + a["flops_int8"] + a["flops_xnor"] == total
    assert rec["collectives"]["total_bytes"] == 0 and rec["roofline"]["t_collective"] == 0


@pytest.mark.parametrize("arch,shape,dims,item", [
    ("rwkv6-3b", TRAIN, (1, 2), "A9 (l)"), ("zamba2-2.7b", TRAIN, (1, 2), "A9 (l)"),
    ("whisper-base", TRAIN, (1, 2), "A9 (l)"), ("deepseek-v2-236b", TRAIN, (2, 1), "A9 (j)"),
    ("minicpm3-4b", TRAIN, (1, 2), "A9 (l)")])
def test_refused_cells_are_skipped_naming_the_roadmap(arch, shape, dims, item):
    rec = _cell(arch, shape, dims)
    assert rec["status"] == "skipped" and f"ROADMAP {item}" in rec["reason"]


@pytest.mark.parametrize("arch,shape", [("minicpm3-4b", DECODE), ("deepseek-v2-236b", PREFILL)],
                         ids=["mla_decode", "moe_prefill"])
def test_mla_and_moe_cells_run_on_a_model_axis(arch, shape):
    """A decode step of MLA and a MoE prefill on a model axis of 2: the
    all_reduces are the call sites (wo and the FFN a dense block; wo, the
    routed pair rows and the shared experts a MoE one; the embedding and
    the logits), and the roofline counts what MLA keeps whole (its down
    projections, the compressed cache) and the router on every rank, the
    routed experts (every int8 FLOP here: the binary ones) 1 / model."""
    cfg = smoke_config(arch)
    rec = _cell(arch, shape, (1, 2), cfg)
    assert rec["status"] == "ok"
    moe_blocks = cfg.n_layers - cfg.first_dense_layers if cfg.n_experts else 0
    assert rec["split"] == {"attn": True, "ffn": True, "vocab": True, "experts": bool(moe_blocks)}
    want = 2 * (cfg.n_layers - moe_blocks) + 3 * moe_blocks + 2
    assert rec["collectives"]["all-reduce"]["count"] == want
    total, rl = AC.step_cost(cfg, shape), rec["roofline"]
    card = hlo_analysis.card_cost(cfg, shape, data=1, model=2, split=rec["split"])
    assert card.flops_int8 == total.flops_int8 / 2 > 0
    assert rl["flops"] > total.flops_total / 2 and rl["hbm_bytes"] > total.hbm_bytes / 2
    if shape.kind == "decode":
        # the whole compressed cache is held and read on each rank
        assert rl["hbm_bytes"] - total.hbm_bytes / 2 >= AC.kv_cache_bytes(cfg, shape) / 2
        assert rec["memory"]["cache_bytes"] >= AC.kv_cache_bytes(cfg, shape)


# all_reduces of one step on a model axis of 2, from the call sites: a
# Mamba2 block 2 (out, gnorm's sum), a shared-block call 2 (wo, the FFN's
# down product), an RWKV6 block 4 (y and g gathered, w_o's columns, c_v,
# the channel-mix's columns), a whisper decoder block 3 (wo, the cross wo,
# the FFN) and an encoder block 2, a VLM self or cross block 2; the
# embedding and the logits 1 each
def _family_all_reduces(cfg, kind):
    if cfg.family == "mamba2_hybrid":
        return 2 * cfg.n_layers + 2 * (cfg.n_layers // cfg.attn_every) + 2
    if cfg.family == "rwkv6":
        return 4 * cfg.n_layers + 2
    if cfg.family == "whisper":
        return 3 * cfg.n_layers + (2 * cfg.enc_layers if kind == "prefill" else 0) + 2
    return 2 * (cfg.n_layers + cfg.n_layers // cfg.cross_every) + 2


@pytest.mark.parametrize("shape", [DECODE, PREFILL], ids=["decode", "prefill"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-3b", "whisper-base",
                                  "llama-3.2-vision-11b"])
def test_recurrent_and_encdec_cells_run_on_a_model_axis(arch, shape):
    """The recurrent families, whisper and the VLM on a model axis of 2:
    every part splits, the all_reduces are the call sites, and a rank's
    argument bytes are its real trees' (the Mamba2 cut: x channels of
    conv beside B and C whole, in_bcdt whole)."""
    cfg = smoke_config(arch)
    rec = _cell(arch, shape, (1, 2), cfg)
    assert rec["status"] == "ok"
    recurrent = cfg.family in ("mamba2_hybrid", "rwkv6")
    want = {"attn": cfg.family != "rwkv6", "ffn": True, "vocab": True, "experts": False}
    assert rec["split"] == (dict(want, mixer=True) if recurrent else want)
    assert rec["collectives"]["all-reduce"]["count"] == _family_all_reduces(cfg, shape.kind)
    api = get_model(cfg)
    mesh = MeshShape((2,), ("model",))
    tp, rules = S.serving_plan(cfg, mesh)
    low = dryrun.lower_cell(arch, shape.name, cfg_override=cfg, shape=shape,
                            mesh=_mesh((1, 2)))[0]
    params = (api.init_deployed(0, device="cpu") if low.weights == "deployed"
              else api.init(0, device="cpu", packed=False))
    assert rec["memory"]["params_bytes"] == _nbytes(S.shard_params(api, params, mesh, tp, rules))


@pytest.mark.parametrize("shape", [DECODE, PREFILL], ids=["decode", "prefill"])
@pytest.mark.parametrize("arch,model", [("zamba2-2.7b", 4), ("whisper-base", 8),
                                        ("llama-3.2-vision-11b", 4)])
def test_roofline_counts_a_family_s_whole_attention_on_every_rank(arch, model, shape):
    """zamba2's 2 smoke Mamba heads at 4 ranks (its mixer and shared
    attention whole), whisper's 4 heads at 8 (d_ff 256: a word a rank), the
    VLM's 2 KV heads at 4: the roofline counts what stays whole on every
    rank, as the rank's counted products show (within 10%)."""
    cfg = smoke_config(arch).replace(d_ff=256) if model == 8 else smoke_config(arch)
    rec = _cell(arch, shape, (1, model), cfg)
    assert rec["status"] == "ok" and not rec["split"]["attn"] and rec["split"]["ffn"]
    assert not rec["split"].get("mixer", False)
    rl = rec["roofline"]
    assert abs(rec["cost"]["flops_counted"] - rl["flops"]) <= 0.1 * rl["flops"]
    total = AC.step_cost(cfg, shape)
    assert rl["flops"] > total.flops_total / model and rl["hbm_bytes"] > total.hbm_bytes / model


@pytest.mark.parametrize("arch", DENSE)
def test_long_500k_skips_on_full_attention(arch):
    rec = dryrun.run_cell(arch, "long_500k", out_dir=None)
    assert rec["status"] == "skipped" and "500k-token KV cache" in rec["reason"]


def test_an_error_is_recorded_with_its_traceback():
    cfg = smoke_config("stablelm-3b").replace(remat="sideways")
    rec = _cell("stablelm-3b", TRAIN, (1, 1), cfg)
    assert rec["status"] == "error" and "unknown remat" in rec["error"]
    assert "Traceback" in rec["traceback"]


def test_cli_writes_a_record_a_cell_with_repro_keys(tmp_path, monkeypatch):
    # smoke widths behind the full configs' names: no full-width step here;
    # d_ff 256 gives each of the 8 model ranks a whole word of bin_out
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_config(a).replace(d_ff=256))
    out = str(tmp_path)
    rec = dryrun.main(["--arch", "stablelm-3b", "--shape", "decode_32k", "--out-dir", out])
    assert rec["status"] == "ok" and rec["mesh"] == "nodes32x8" and rec["n_chips"] == 256
    assert REPRO_KEYS <= set(rec) and REPRO_COLLECTIVES <= set(rec["collectives"])
    assert set(rec["roofline"]) == {"flops", "hbm_bytes", "coll_bytes", "t_compute",
                                    "t_memory", "t_collective", "bottleneck", "step_time_est"}
    assert set(rec["analytic"]) == {"flops_bf16", "flops_int8", "flops_xnor", "hbm_bytes"}
    assert {"argument_bytes", "output_bytes", "temp_bytes"} <= set(rec["memory"])
    assert rec["rows_per_card"] == 128 // 32
    assert not torch.distributed.is_initialized()       # no process group, ever
    recs = dryrun.main(["--sweep", "--arch", "whisper-base", "--single-pod-only",
                        "--out-dir", out])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(["stablelm-3b__decode_32k__nodes32x8.json"] +
                           [f"whisper-base__{s}__nodes32x8.json"
                            for s in ("decode_32k", "long_500k", "prefill_32k", "train_4k")])
    # whisper's 4 smoke heads do not split 8 ways: its attention runs whole
    # on every rank of the model axis, its FFNs and vocab split
    assert [r["status"] for r in recs] == ["ok", "skipped", "ok", "skipped"]
    assert recs[0]["split"] == {"attn": False, "ffn": True, "vocab": True, "experts": False}
    with open(tmp_path / "whisper-base__train_4k__nodes32x8.json") as f:
        assert "ROADMAP A9 (l)" in json.load(f)["reason"]
    # resumable: the records are read back, not redone
    again = dryrun.sweep(multi_pod_values=(False,), out_dir=out, only_arch="whisper-base")
    assert again == recs


def test_recording_issues_nothing_and_counting_is_per_axis():
    collectives.zero_counts()
    x = torch.ones(3, dtype=torch.float32)
    with collectives.recording() as rec:
        assert collectives.all_reduce(x, axis="model") is x
        collectives.broadcast(torch.zeros(2, dtype=torch.int8), src=0, axis="model")
        collectives.all_reduce(torch.ones(4, dtype=torch.int32), axis="data")
    assert collectives.counts() == {}
    s = rec.summary()
    # payload 12 + 16 all-reduced (x 2 on the wire), 2 broadcast
    assert (s["all-reduce"], s["broadcast"]) == ({"bytes": 56, "count": 2, "payload_bytes": 28},
                                                  {"bytes": 2, "count": 1, "payload_bytes": 2})
    assert (s["total_bytes"], s["payload_bytes"]) == (58, 30)
    assert s["by_axis"] == {"model": {"bytes": 26, "count": 2, "payload_bytes": 14},
                            "data": {"bytes": 32, "count": 1, "payload_bytes": 16}}


def test_perf_pair_prints_repro_table(tmp_path, capsys, monkeypatch):
    # smoke widths behind the full configs' names, at a small shape and mesh
    monkeypatch.setattr(perf, "get_config", smoke_config)
    monkeypatch.setattr(perf, "run_cell", functools.partial(dryrun.run_cell, shape=TRAIN,
                                                            mesh=_mesh((1, 2))))
    monkeypatch.setattr(perf, "PERF_DIR", tmp_path)
    rows = perf.run_pair("qwen3_train")
    out = capsys.readouterr().out
    assert "=== qwen3_train (qwen3-8b x train_4k) ===" in out
    assert "variant" in out and "args GiB/dev" in out
    assert [r[0] for r in rows] == ["base", "kv_replicated", "remat_dots", "attnchunk4k",
                                    "xnor_train"]
    assert [r[4] for r in rows[:2]] != ["skipped", "skipped"]
    # replicated K/V: attention runs whole on every rank, fewer all_reduces
    assert rows[1][3] < rows[0][3]
    for r in rows[2:]:             # remat "dots" (all three pin it) is refused
        assert r[4] == "skipped" and 'remat="dots"' in r[5]
    assert len(list(tmp_path.iterdir())) == 5
