"""Sharded training on the CPU: gloo ranks in spawned processes
(launch/mesh.spawn), one spawn per world size (2 and 4), on smoke configs
in f32 with repro's own init carried over (models/convert.py).

* stablelm-3b at (data, model) = (1, 2) and (2, 1): step 0's loss equals
  the port's single-device loss (1e-6 relative) and repro's (1e-5), as
  tests/test_sharding_mini.py holds repro's mesh loss to its single
  device's, and the global norm is within 1e-6; after one step every
  gradient and param, gathered to each `model` group's rank 0 (so each
  replica over `data` is checked), is within TRAIN_TOL of the single
  device's (tests/test_torch_cuda.py).
* The backward of a (1, 2) loss run on another thread (as autograd runs
  it on the card) gives the same gradients: remat's recompute re-enters
  the tensor-parallel scope.
* qwen3-8b at (2, 2) on 4 ranks: its q_norm / k_norm, replicated scales
  applied to a rank's heads, get the single device's gradients.
* Elastic checkpoints: saved under (1, 2) (shards gathered, rank 0
  writes), restored under (2, 1) and under one device: the whole tree bit
  for bit, the step and the data state.
* The launcher: --mesh 1x2 for 3 steps with a checkpoint, then --mesh 2x1
  --resume for one more, against the same without --mesh (bf16, binary
  FFNs: step 0's loss within 1e-5, the later steps within the bar below).
* The collectives each rank's train step issued, counted by the entry
  point (distributed/collectives.py), equal the dry run's record of the
  same step on fake tensors (launch/dryrun.py), at (1, 2), (2, 1) and
  qwen3-8b's (2, 2).
* The refusals: an arch outside the GQA dense family at model > 1, an
  arch with MoE layers at data > 1, a batch that does not divide over
  data, a malformed --mesh.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens  # noqa: E402
from repro_torch.distributed import collectives  # noqa: E402
from repro_torch.distributed.sharding import tensor_parallel  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.launch.mesh import MeshShape, make_mesh, spawn  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.train import checkpoint as C  # noqa: E402
from repro_torch.train.step import loss_and_grads, make_train_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_leaves_with_path  # noqa: E402

torch.set_num_threads(2)

TRAIN_TOL = {"grad": 1e-4, "param": 1e-3}     # tests/test_torch_cuda.py TRAIN_TOL
MESHES = ((1, 2), (2, 1))
SEQ, BATCH = 32, 8
STEP = dict(peak_lr=1e-3, warmup=1, total=10)
# bf16 with binary FFNs: the ranks' row-parallel sums and data-parallel
# gradient means round apart from the single device's, and sign() turns
# that into O(1e-3) loss changes after the first update (f32 holds 1e-6)
LAUNCHER_LATER_REL = 1e-2


def _f32(arch):
    return smoke_config(arch).replace(compute_dtype="float32", param_dtype="float32")


def _batch(vocab):
    return {k: torch.from_numpy(v) for k, v in next(SyntheticTokens(vocab, SEQ, BATCH,
                                                                     seed=0)).items()}


def _np(tree):
    """(path, array) per leaf; None for a gather's None (a rank that keeps
    nothing)."""
    if tree is None:
        return None
    return [(p, t.detach().numpy()) for p, t in tree_leaves_with_path(tree)]


def _one_step(api, cfg, params, batch, plan=None):
    """-> loss, gathered grads and params after one step, grad_norm, and
    the collectives the step issued (the entry point's counts)."""
    if plan is not None:
        batch = {k: plan.dp.rows(v) for k, v in batch.items()}
    with tensor_parallel(None if plan is None else plan.tp):
        _, metrics, grads = loss_and_grads(api, params, batch)
    if plan is not None:
        grads, metrics = plan.sync(grads, metrics)
    collectives.zero_counts()
    new, _, m = make_train_step(api, cfg, plan=plan, **STEP)(params, adamw_init(params), batch)
    issued = collectives.counts()
    if plan is not None:
        grads, new = plan.gather(api, grads), plan.gather(api, new)
    return dict(loss=float(metrics["loss"]), grads=_np(grads), params=_np(new),
                grad_norm=float(m["grad_norm"]), step_loss=float(m["loss"]),
                collectives=issued)


def _grads_on_a_thread(api, params, batch, plan):
    """Forward here, backward on another thread."""
    import threading

    from repro_torch.tree import tree_unflatten_like
    batch = {k: plan.dp.rows(v) for k, v in batch.items()}
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with tensor_parallel(plan.tp):
        loss, _ = api.loss(tree_unflatten_like(params, live), batch)
    out = {}
    t = threading.Thread(target=lambda: out.update(g=torch.autograd.grad(loss, live)))
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    return _np(plan.gather(api, tree_unflatten_like(params, list(out["g"]))))


def _ranks2(rank, world, cfg, params, batch, ckpt_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    api = get_model(cfg)
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    out = {}
    for dims in MESHES:
        plan = S.mesh_train_plan(cfg, make_mesh(dims, ("data", "model")), shape)
        local = plan.shard(api, params)
        out[dims] = _one_step(api, cfg, local, batch, plan)
        if dims == (1, 2):
            out["thread_grads"] = _grads_on_a_thread(api, local, batch, plan)
            new, opt, _ = make_train_step(api, cfg, plan=plan, **STEP)(
                local, adamw_init(local), {k: plan.dp.rows(v) for k, v in batch.items()})
            whole = plan.gather(api, {"params": new, "opt": opt})
            if rank == 0:
                C.save(ckpt_dir, 1, whole, meta={"data_state": {"step": 1, "seed": 0}})
            out["saved"] = _np(whole)
            dist.barrier()
    # restore under (2, 1): model 1 cuts nothing, each data rank holds all
    plan = S.mesh_train_plan(cfg, make_mesh((2, 1), ("data", "model")), shape)
    like = S.abstract(lambda: {"params": api.init(0, device="cpu", packed=False),
                               "opt": adamw_init(api.init(0, device="cpu", packed=False))})
    tree, meta = C.restore(ckpt_dir, 1, like)
    out["restored_2x1"] = (_np(plan.shard(api, tree)), meta)
    out["ckpt_dir"] = ckpt_dir
    return out


def _ranks4(rank, world, cfg, params, batch):
    torch.set_num_threads(1)
    api = get_model(cfg)
    plan = S.mesh_train_plan(cfg, make_mesh((2, 2), ("data", "model")),
                             ShapeSpec("t", SEQ, BATCH, "train"))
    assert plan.tp.attn and plan.tp.ffn and plan.tp.vocab
    return _one_step(api, cfg, plan.shard(api, params), batch, plan)


def _from_repro(arch):
    """(cfg, port params, batch, repro's loss on them) from repro's init."""
    import jax
    import jax.numpy as jnp

    from repro.configs import smoke_config as jax_smoke
    from repro.models import get_model as jax_model
    from repro_torch.models.convert import params_from_jax
    jcfg = jax_smoke(arch).replace(compute_dtype="float32", param_dtype="float32")
    japi = jax_model(jcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    cfg = _f32(arch)
    batch = _batch(cfg.vocab)
    jloss, _ = japi.loss(jparams, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, device="cpu", packed=False)
    return cfg, params, batch, float(jloss)


@pytest.fixture(scope="module")
def stablelm():
    cfg, params, batch, jloss = _from_repro("stablelm-3b")
    return cfg, params, batch, jloss, _one_step(get_model(cfg), cfg, params, batch)


@pytest.fixture(scope="module")
def runs2(stablelm, tmp_path_factory):
    cfg, params, batch, _, _ = stablelm
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    return spawn(_ranks2, 2, backend="gloo", args=(cfg, params, batch, ckpt), timeout=300)


@pytest.fixture(scope="module")
def qwen3():
    cfg, params, batch, jloss = _from_repro("qwen3-8b")
    single = _one_step(get_model(cfg), cfg, params, batch)
    ranks = spawn(_ranks4, 4, backend="gloo", args=(cfg, params, batch), timeout=300)
    return single, jloss, ranks


def _rel(a, b):
    return abs(a - b) / abs(b)


def _leaf_errs(got, want):
    return {p: float(np.abs(a - w).max()) / max(float(np.abs(w).max()), 1e-30)
            for (p, a), (q, w) in zip(got, want) if p == q}


def _check_step(out, single, jloss):
    assert _rel(out["loss"], single["loss"]) <= 1e-6
    assert _rel(out["step_loss"], single["loss"]) <= 1e-6
    assert _rel(out["loss"], jloss) <= 1e-5
    assert _rel(out["grad_norm"], single["grad_norm"]) <= 1e-6
    if out["grads"] is None:              # not its model group's rank 0
        return
    for what in ("grads", "params"):
        assert [p for p, _ in out[what]] == [p for p, _ in single[what]]
        errs = _leaf_errs(out[what], single[what])
        worst = max(errs, key=errs.get)
        assert errs[worst] <= TRAIN_TOL[what[:-1]], (what, worst, errs[worst])


@pytest.mark.parametrize("dims", MESHES)
def test_mesh_step_equals_single_device_and_repro(stablelm, runs2, dims):
    _, _, _, jloss, single = stablelm
    assert _rel(single["loss"], jloss) <= 1e-5
    # the gathered trees are on each model group's rank 0 only
    assert [r[dims]["grads"] is not None for r in runs2] == [True, dims[1] == 1]
    for rank_out in runs2:
        _check_step(rank_out[dims], single, jloss)


def _dry_run_collectives(arch, cfg, dims):
    """The dry run's collectives of the same step -> the entry point's
    layout ({op: {axis: {"calls", "bytes"}}}, payload bytes)."""
    rec = dryrun.run_cell(arch, "t", cfg_override=cfg, shape=ShapeSpec("t", SEQ, BATCH, "train"),
                          mesh=MeshShape(dims, ("data", "model")), out_dir=None)
    assert rec["status"] == "ok"
    return {"all-reduce": {axis: {"calls": v["count"], "bytes": v["payload_bytes"]}
                           for axis, v in rec["collectives"]["by_axis"].items()}}


@pytest.mark.parametrize("dims", MESHES)
def test_issued_collectives_equal_the_dry_run(stablelm, runs2, dims):
    """What each gloo rank's train step issued through the entry point
    (calls and payload bytes per mesh axis) = what the dry run records for
    the same smoke config and mesh on fake tensors."""
    want = _dry_run_collectives("stablelm-3b", stablelm[0], dims)
    assert want["all-reduce"]
    for rank_out in runs2:
        assert rank_out[dims]["collectives"] == want
    assert stablelm[4]["collectives"] == {}          # one device issues none


def test_issued_collectives_equal_the_dry_run_on_a_2x2_mesh(qwen3):
    want = _dry_run_collectives("qwen3-8b", _f32("qwen3-8b"), (2, 2))
    assert set(want["all-reduce"]) == {"model", "data"}
    for rank_out in qwen3[2]:
        assert rank_out["collectives"] == want


def test_recompute_reenters_the_scope_on_another_thread(stablelm, runs2):
    cfg = stablelm[0]
    assert cfg.remat == "block"
    assert runs2[0]["thread_grads"] is not None and runs2[1]["thread_grads"] is None
    for (p, got), (_, want) in zip(runs2[0]["thread_grads"], runs2[0][(1, 2)]["grads"]):
        assert np.array_equal(got, want), p


def test_qk_norm_grads_on_a_2x2_mesh(qwen3):
    single, jloss, ranks = qwen3
    names = [p for p, _ in single["grads"]]
    assert any(p.endswith("q_norm/scale") for p in names)
    # ranks 0 and 2 are model rank 0 of data replicas 0 and 1
    assert [r["grads"] is not None for r in ranks] == [True, False, True, False]
    for rank_out in ranks:
        _check_step(rank_out, single, jloss)


def test_checkpoint_saved_on_1x2_restores_on_2x1_and_one_device(stablelm, runs2):
    cfg = stablelm[0]
    saved = dict(runs2[0]["saved"])
    for rank_out in runs2:
        tree, meta = rank_out["restored_2x1"]
        assert meta["step"] == 1 and meta["data_state"] == {"step": 1, "seed": 0}
        assert sorted(p for p, _ in tree) == sorted(saved)
        for p, a in tree:
            b = saved[p]
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), p
    # the single-device --resume reads the same file
    api = get_model(cfg)
    init = api.init(0, device="cpu", packed=False)
    tree, meta = C.restore(runs2[0]["ckpt_dir"], 1, {"params": init, "opt": adamw_init(init)})
    assert meta["step"] == 1
    for p, a in _np(tree):
        assert a.tobytes() == saved[p].tobytes(), p


def test_launcher_mesh_equals_single_device(tmp_path):
    """--mesh 1x2 for 3 steps (checkpoint at 3), then --mesh 2x1 --resume
    for one more, against the same runs without a mesh."""
    base = ["--smoke", "--device", "cpu", "--seq", "16", "--batch", "4", "--log-every", "1"]
    runs = {}
    for tag, mesh in (("single", ""), ("mesh", "1x2:data,model")):
        ck = str(tmp_path / tag)
        first = train_cli.main(base + ["--steps", "3", "--ckpt-dir", ck, "--mesh", mesh])
        mesh2 = "2x1:data,model" if mesh else ""
        more = train_cli.main(base + ["--steps", "1", "--ckpt-dir", ck, "--resume",
                                      "--mesh", mesh2])
        runs[tag] = [h["loss"] for h in first + more]
        assert C.latest_step(ck) == 4
    single, mesh = runs["single"], runs["mesh"]
    assert len(mesh) == len(single) == 4 and all(np.isfinite(mesh))
    assert _rel(mesh[0], single[0]) <= 1e-5
    assert max(_rel(a, b) for a, b in zip(mesh, single)) <= LAUNCHER_LATER_REL, (mesh, single)


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "deepseek-v3-671b"])
def test_train_plan_refuses_moe_on_a_data_axis(arch):
    """Each rank would size expert capacity and the router's aux loss on
    its own rows, not the global batch's: refused at data > 1, also by the
    launcher before any rank starts; one data rank is the single device."""
    cfg = smoke_config(arch)
    assert cfg.n_experts
    assert S.train_plan(cfg, _Mesh({"data": 1, "model": 1})).dp.size == 1
    with pytest.raises(NotImplementedError, match="ROADMAP A9 \\(j\\)"):
        S.train_plan(cfg, _Mesh({"data": 2, "model": 1}))
    with pytest.raises(NotImplementedError, match="ROADMAP A9 \\(j\\)"):
        train_cli.main(["--smoke", "--device", "cpu", "--arch", arch, "--mesh",
                        "2x1:data,model"])


class _Mesh:
    def __init__(self, shape: dict):
        self.axis_names, self.shape = tuple(shape), shape


def test_train_plan_splits_as_serving_and_refuses():
    cfg = smoke_config("stablelm-3b")
    plan = S.train_plan(cfg, _Mesh({"data": 2, "model": 2}), ShapeSpec("t", 8, 4, "train"))
    tp, _ = S.serving_plan(cfg, _Mesh({"model": 2}))
    assert (plan.tp.attn, plan.tp.ffn, plan.tp.vocab) == (tp.attn, tp.ffn, tp.vocab)
    assert plan.dp.size == 2 and plan.rules.rules["batch"] == ("data",)
    assert not S.train_plan(cfg.replace(fsdp=True), _Mesh({"data": 2})).rules.fsdp
    # a data axis takes any family without MoE layers; a model axis > 1
    # only the GQA dense one: every other family is A9 (l)
    for arch in ("minicpm3-4b", "zamba2-2.7b", "rwkv6-3b", "whisper-base"):
        assert S.train_plan(smoke_config(arch), _Mesh({"data": 2, "model": 1})).dp.size == 2
    for arch, item in (("minicpm3-4b", "l"), ("deepseek-v2-236b", "l"), ("zamba2-2.7b", "l"),
                       ("rwkv6-3b", "l"), ("whisper-base", "l")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP A9 \\({item}\\)"):
            S.train_plan(smoke_config(arch), _Mesh({"data": 1, "model": 2}))
    with pytest.raises(ValueError, match="does not split over data 2"):
        S.train_plan(cfg, _Mesh({"data": 2, "model": 1}), ShapeSpec("t", 8, 3, "train"))
    with pytest.raises(ValueError, match="`data` and `model` axes"):
        S.train_plan(cfg, _Mesh({"pod": 2, "model": 1}))
    with pytest.raises(ValueError, match="does not split over data 2"):
        train_cli.main(["--smoke", "--device", "cpu", "--batch", "3", "--mesh",
                        "2x1:data,model"])
    with pytest.raises(NotImplementedError, match="ROADMAP A9 \\(l\\)"):
        train_cli.main(["--smoke", "--device", "cpu", "--arch", "rwkv6-3b", "--mesh",
                        "1x2:data,model"])
    for bad in ("2x2", "2x:data,model", "2x2:data"):
        with pytest.raises(ValueError, match="--mesh"):
            train_cli.parse_mesh(bad)
