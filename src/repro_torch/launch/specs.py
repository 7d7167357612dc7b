"""Abstract stand-ins for every model input, the sharding trees for params,
optimizer state, batches and caches, and the serving and training plans
of a mesh (port of repro/launch/specs.py).

Nothing here allocates: params and caches are built under torch's
FakeTensorMode (shapes and dtypes alone) and batches on the meta device,
so the 671B configs cost nothing to describe. A "sharding" is a tree of
DTensor placements (distributed/sharding.placements), the counterpart of
repro's NamedShardings; the specs themselves come from partition_specs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import (DataParallel, MeshRules, TensorParallel,
                                              _entry_axes, axis_names, axis_sizes, local_shard,
                                              logical_to_spec, partition_specs, placements,
                                              shard_shape)
from repro_torch.tree import tree_leaves, tree_leaves_with_path, tree_map, tree_unflatten_like

# cache-leaf sharding rules (the same machinery as params)
CACHE_RULES = [
    (r"(^|/)(k|v|ek|ev)$", ("batch", "cache_seq", "cache_heads", "kv")),
    (r"(^|/)c$", ("batch", "cache_seq", "kv_lora")),
    (r"(^|/)kr$", ("batch", "cache_seq", "kv_lora")),
    (r"(^|/)len$", ("batch",)),
    (r"(^|/)h$", ("batch", "heads", "kv", "state")),      # mamba SSM state
    (r"(^|/)conv$", ("batch", "seq", "dconv")),
    (r"tm_s$", ("batch", "heads", "kv", "state")),
    (r"(tm_x|cm_x)$", ("batch", "seq", "embed")),
    (r"cross$", ("batch", "seq", "embed")),               # vlm patch embeds
]

BATCH_RULES = [
    (r"(tokens|labels)$", ("batch", "seq")),
    (r"frames$", ("batch", "seq", "embed")),
    (r"patches$", ("batch", "seq", "embed")),
]


def mesh_rules_for(cfg: ModelConfig, mesh, shape: ShapeSpec | None = None) -> MeshRules:
    """Adapt the default logical -> mesh table to this arch and cell.

    Anything uneven falls back to the widest divisible sharding (as in
    repro, where jit demands exact divisibility): e.g. 40-head archs
    replicate attention over the model axis."""
    rules = MeshRules(fsdp=cfg.fsdp)
    over = {}
    sizes = axis_sizes(mesh)
    model_n = sizes.get("model", 1)
    dh = cfg.kv_head_dim()
    if cfg.n_heads % model_n or (cfg.n_heads * dh) % model_n:
        over["heads"] = None
    if (cfg.n_kv_heads * dh) % model_n or not cfg.shard_kv_heads:
        over["kv_heads"] = None
    if cfg.n_kv_heads % model_n:
        over["cache_heads"] = None
    if cfg.serve_shard_cache_seq:
        # sequence-parallel decode attention: the cache's time axis over
        # "model", which the head axis then leaves
        over["cache_seq"] = "model"
        over["cache_heads"] = None
    if cfg.family == "mamba2_hybrid":
        di = cfg.expand * cfg.d_model
        if (di // 64) % model_n:      # mamba heads
            over["heads"] = None
    # batch divisibility: drop axes until the global batch divides
    if shape is not None:
        axes = [a for a in ("pod", "data") if a in axis_names(mesh)]
        while axes:
            n = 1
            for a in axes:
                n *= sizes[a]
            if shape.global_batch % n == 0:
                break
            axes.pop(0)
        over["batch"] = tuple(axes) if axes else None
    if over:
        rules.rules = dict(rules.rules, **over)
    return rules


def abstract(fn):
    """fn() under FakeTensorMode: its tensors carry shapes and dtypes and
    no storage."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return fn()


def abstract_params(api, *, deployed: bool = False, packed: bool = False):
    """The params' shapes and dtypes: latents only by default, as repro's
    init; ``packed`` adds the serving copies, ``deployed`` drops latents
    for quantized weights (models/deploy.py)."""
    if deployed:
        return abstract(lambda: api.init_deployed(0, device="cpu"))
    return abstract(lambda: api.init(0, device="cpu", packed=packed))


def _placements(specs, mesh):
    return tree_map(lambda s: placements(s, mesh), specs)


def param_shardings(api, mesh, mesh_rules, *, deployed: bool = False):
    p_abs = abstract_params(api, deployed=deployed)
    rules = api.deployed_rules if deployed else api.param_rules
    return p_abs, _placements(partition_specs(p_abs, rules, mesh, mesh_rules), mesh)


def opt_shardings(api, cfg, p_abs, p_sh, mesh):
    import torch

    from repro_torch.optim import adamw_init
    mdt = getattr(torch, cfg.opt_moment_dtype)
    o_abs = abstract(lambda: adamw_init(p_abs, moment_dtype=mdt))
    o_sh = {"m": p_sh, "v": p_sh, "step": placements((), mesh)}
    return o_abs, o_sh


def make_lm_batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta tensors for a training batch of this arch x shape."""
    import torch
    b, s = shape.global_batch, shape.seq_len
    meta = dict(device="meta")
    specs = {"tokens": torch.empty((b, s), dtype=torch.int32, **meta),
             "labels": torch.empty((b, s), dtype=torch.int32, **meta)}
    if cfg.family == "whisper":
        specs["frames"] = torch.empty((b, cfg.n_audio_frames, cfg.d_model),
                                      dtype=torch.bfloat16, **meta)
    if cfg.family == "vlm":
        specs["patches"] = torch.empty((b, cfg.n_patches, cfg.d_model),
                                       dtype=torch.bfloat16, **meta)
    return specs


def batch_specs_and_shardings(cfg, shape: ShapeSpec, mesh, mesh_rules):
    specs = make_lm_batch_specs(cfg, shape)
    return specs, _placements(partition_specs(specs, BATCH_RULES, mesh, mesh_rules), mesh)


def cache_specs_and_shardings(api, cfg, shape: ShapeSpec, mesh, mesh_rules):
    b, s = shape.global_batch, shape.seq_len
    cache_abs = abstract(lambda: api.init_cache(b, s, "cpu"))
    return cache_abs, _placements(partition_specs(cache_abs, CACHE_RULES, mesh, mesh_rules),
                                  mesh)


def decode_token_specs(cfg, shape: ShapeSpec, mesh, mesh_rules):
    import torch
    spec = torch.empty((shape.global_batch, 1), dtype=torch.int32, device="meta")
    return spec, placements(logical_to_spec(("batch", "seq"), mesh, mesh_rules), mesh)


def input_specs(arch_or_cfg, shape: ShapeSpec, *, kind=None):
    """Abstract stand-ins for every input of the step this cell runs."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    cfg = arch_or_cfg if isinstance(arch_or_cfg, ModelConfig) else get_config(arch_or_cfg)
    kind = kind or shape.kind
    if kind in ("train", "prefill"):
        return make_lm_batch_specs(cfg, shape)
    b = shape.global_batch
    api = get_model(cfg)
    return {"tokens": torch.empty((b, 1), dtype=torch.int32, device="meta"),
            "caches": abstract(lambda: api.init_cache(b, shape.seq_len, "cpu"))}


# ---------------------------------------------------------------------------
# tensor-parallel serving: the plan of a `model` mesh and each rank's shard
# ---------------------------------------------------------------------------

def _model_split(cfg: ModelConfig, mesh, rules: MeshRules) -> dict[str, bool]:
    """{"attn", "ffn", "vocab", "experts", "mixer"}: what the ``model`` axis
    splits under ``rules`` (mesh_rules_for's), whose entries for the parts
    it does not split are set to None here, and whose ``cuts`` it sets.
    GQA attention (every family's but RWKV6's) splits where its heads,
    flattened K/V and cache heads all do; MLA's where its heads do (its
    down projections and its compressed cache have no head axis and stay
    whole on every rank). ``ffn`` covers the dense FFNs, zamba2's shared
    block's, RWKV6's channel-mix c_k / c_v and the MoE layers' shared
    experts, ``experts`` the routed expert stacks. ``mixer``: Mamba2's heads
    where ``heads``, ``mlp`` and ``dconv`` all split (and the shared
    block's attention with them), RWKV6's time-mix where ``heads`` does;
    a part the rules replicate runs whole, as repro's. A split FFN must
    give each rank whole packed words of bin_out (d_ff / N a multiple of
    32; a split Mamba2 out always does: a head is 64 channels), the
    experts and the vocab must divide: else this raises, naming the
    shape."""
    n = axis_sizes(mesh).get("model", 1)
    names = axis_names(mesh)

    def on_model(*logical):
        return n > 1 and all(rules.mesh_axes(a, names) == "model" for a in logical)
    attn = cfg.family != "rwkv6" and (
        on_model("heads") if cfg.use_mla else on_model("heads", "kv_heads", "cache_heads"))
    ffn, vocab = on_model("mlp"), on_model("vocab")
    experts = bool(cfg.n_experts) and on_model("expert")
    mixer = {"mamba2_hybrid": attn and on_model("mlp", "dconv"),
             "rwkv6": on_model("heads")}.get(cfg.family, False)
    from repro_torch.models.lm_common import padded_vocab
    if ffn:
        per = cfg.d_ff // n
        if cfg.d_ff % n or (cfg.policy.binary_ffn and per % 32):
            raise ValueError(f"d_ff {cfg.d_ff} does not split into {n} shards of whole "
                             f"32-bit words (a shard of bin_out packs its K = d_ff / {n} "
                             "along words; uneven word-aligned shards are ROADMAP A9 (k))")
    if experts and cfg.n_experts % n:
        raise ValueError(f"n_experts {cfg.n_experts} does not split into {n} shards of "
                         "whole experts")
    if vocab and padded_vocab(cfg.vocab) % n:
        raise ValueError(f"the padded vocab {padded_vocab(cfg.vocab)} does not split {n} ways")
    over = {}
    if not (attn or mixer):
        over["heads"] = None
    if not attn:
        over.update(kv_heads=None, cache_heads=None)
    if not mixer:
        over["dconv"] = None
    if not ffn:
        over["mlp"] = None
    if not experts:
        over["expert"] = None
    if not vocab:
        over["vocab"] = None
    rules.rules = dict(rules.rules, **over)
    from repro_torch.models import mesh_cuts
    rules.cuts = mesh_cuts(cfg, mixer) if n > 1 else []
    return dict(attn=attn, ffn=ffn, vocab=vocab, experts=experts, mixer=mixer)


def serving_plan(cfg: ModelConfig, mesh, *, rank: int = 0, group=None
                 ) -> tuple[TensorParallel, MeshRules]:
    """-> (what rank ``rank`` of the ``model`` axis splits, the rules that
    place its params and caches), for every family.

    mesh_rules_for decides; where it splits the flattened K/V projection
    but not the cache heads (fewer KV heads than ranks), a rank would hold
    part of a head, so the attention block is replicated whole instead
    (GSPMD would gather the split heads back). MLA splits its heads alone
    (_model_split), MoE layers their routed experts (``experts``) and
    shared experts (``ffn``), the recurrent families their heads
    (``mixer``). A split FFN must give each rank whole packed words of
    bin_out (d_ff / N a multiple of 32), and the experts and the vocab
    must divide: else this raises, naming the shape. A mesh of one splits
    nothing: the forward is the single-device one."""
    sizes = axis_sizes(mesh)
    if "model" not in sizes or any(n > 1 for a, n in sizes.items() if a != "model"):
        raise ValueError(f"serving takes a mesh with one `model` axis, got {sizes}: the "
                         "reference serves on a `model` mesh only "
                         "(src/repro/launch/serve.py:211-219)")
    rules = mesh_rules_for(cfg, mesh)
    split = _model_split(cfg, mesh, rules)
    return TensorParallel(size=sizes["model"], rank=rank, group=group, **split), rules


def mesh_tensor_parallel(cfg: ModelConfig, mesh) -> tuple[TensorParallel, MeshRules]:
    """serving_plan for this process's rank of a DeviceMesh."""
    tp, rules = serving_plan(cfg, mesh)
    return dataclasses.replace(tp, rank=mesh.get_local_rank("model"),
                               group=mesh.get_group("model")), rules


def shard_params(api, params, mesh, tp: TensorParallel, rules: MeshRules):
    """Rank ``tp.rank``'s shard of the full ``params`` (latents, packed or
    deployed weights): each leaf cut by its spec (api.deployed_rules under
    ``rules``), or by ``rules``' cut where one matches its path, into an
    allocation of its own; replicated leaves are the full tree's own
    tensors."""
    specs = partition_specs(params, api.deployed_rules, mesh, rules)
    coords = {a: 0 for a in axis_names(mesh)}
    coords["model"] = tp.rank
    return tree_unflatten_like(params, [
        local_shard(t, s, mesh, coords, rules.segments(path))
        for (path, t), s in zip(tree_leaves_with_path(params), tree_leaves(specs))])


def shard_shapes(api, params, mesh, rules: MeshRules):
    """A tree of (shape, dtype): what a rank holds of each leaf of
    ``params`` (shapes suffice) under shard_params' cut."""
    specs = partition_specs(params, api.deployed_rules, mesh, rules)
    return tree_unflatten_like(params, [
        (shard_shape(t.shape, s, mesh, rules.segments(path)), t.dtype)
        for (path, t), s in zip(tree_leaves_with_path(params), tree_leaves(specs))])


# ---------------------------------------------------------------------------
# sharded training: the plan of a (data, model) mesh
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainPlan:
    """What one rank of a training mesh does: the ``model`` axis splits the
    forward as in serving (``tp``), the ``data`` axis splits every global
    batch's rows (``dp``), and ``rules`` place the params, whose moments
    take the same shards; params stay replicated over ``data`` (no ZeRO)."""
    tp: TensorParallel
    dp: DataParallel
    rules: MeshRules
    mesh: object

    def _specs(self, api, tree):
        return partition_specs(tree, api.deployed_rules, self.mesh, self.rules)

    def shard(self, api, tree):
        """This rank's shard of a whole tree (params, or {"params", "opt"}:
        the rules' paths match under any prefix)."""
        return shard_params(api, tree, self.mesh, self.tp, self.rules)

    def split(self, api, tree):
        """A tree of bools: True where a leaf is split over ``model``."""
        return tree_map(lambda s: any("model" in _entry_axes(e) for e in s), self._specs(api, tree))

    def gather(self, api, tree):
        """The whole tree from the ``model`` group's shards, in host memory
        on the group's rank 0; None on its other ranks. Every rank of the
        group takes part: each split leaf's shards are broadcast in turn
        (bits unchanged), and each one that arrives goes to rank 0's host
        at once, so a device holds at most one shard more than its own."""
        import torch
        import torch.distributed as dist

        from repro_torch.distributed import collectives
        keep = self.tp.rank == 0

        def one(t, spec):
            dims = [d for d, e in enumerate(spec) if "model" in _entry_axes(e)]
            if not dims:
                return t.cpu() if keep else None
            parts = []
            for r in range(self.tp.size):
                buf = t.contiguous() if r == self.tp.rank else torch.empty_like(t)
                src = r if self.tp.group is None else dist.get_global_rank(self.tp.group, r)
                collectives.broadcast(buf, src=src, axis="model", group=self.tp.group)
                if keep:
                    parts.append(buf.cpu())
                del buf
            return torch.cat(parts, dim=dims[0]) if keep else None
        with torch.no_grad():
            whole = tree_map(one, tree, self._specs(api, tree))
        return whole if keep else None

    def sync(self, grads, metrics: dict):
        """(grads, metrics) averaged over ``data``: the gradients in f32
        buckets, cast back to each leaf's dtype; the metrics likewise."""
        if self.dp.size == 1:
            return grads, metrics
        import torch

        from repro_torch.tree import tree_leaves, tree_unflatten_like
        grads = tree_unflatten_like(grads, self.dp.mean(tree_leaves(grads)))
        names = sorted(metrics)
        vec = self.dp.mean([torch.stack([metrics[k].to(torch.float32) for k in names])])[0]
        return grads, {k: vec[i].to(metrics[k].dtype) for i, k in enumerate(names)}

    def clip_args(self, api, grads) -> dict:
        """clip_by_global_norm's mesh arguments: none where ``model`` splits
        nothing (every rank then holds every gradient whole)."""
        if self.tp.size == 1:
            return {}
        return {"split": self.split(api, grads), "reduce": self.tp.all_reduce}


def train_plan(cfg: ModelConfig, mesh, shape: ShapeSpec | None = None) -> TrainPlan:
    """-> the TrainPlan of rank 0 of a mesh with ``data`` and ``model``
    axes. ``model`` splits as serving_plan does (the GQA dense family
    only, where it is > 1: the other families are ROADMAP A9 (l)); ``data``
    splits the batch by mesh_rules_for's ``batch`` rule, and a ``shape``
    whose global batch does not divide over it is refused, as is a
    ``data`` axis > 1 for a config with MoE layers (ROADMAP A9 (j)). fsdp configs keep their params replicated over
    ``data`` (ZeRO-3 over it is not ported: the same numbers, more
    memory)."""
    sizes = axis_sizes(mesh)
    other = {a: n for a, n in sizes.items() if a not in ("data", "model") and n > 1}
    if other:
        raise ValueError(f"a training mesh takes `data` and `model` axes, got {sizes}")
    n, d = sizes.get("model", 1), sizes.get("data", 1)
    if n > 1 and (cfg.family not in ("dense", "moe") or cfg.use_mla or cfg.n_experts):
        raise NotImplementedError(
            f"tensor-parallel training of {cfg.name!r} ({cfg.family}"
            f"{', MLA' if cfg.use_mla else ''}) is not ported: it covers the GQA dense "
            "family; the others need the backward of the MoE pair rows' gather, of MLA's "
            "replicated down projections and of the recurrent mixers' norm collective "
            "(ROADMAP A9 (l): tensor-parallel training beyond the GQA dense family)")
    if d > 1 and cfg.n_experts:
        raise NotImplementedError(
            f"data-parallel training of {cfg.name!r}'s MoE layers is not ported: each rank "
            "would size expert capacity and average the router's aux loss over its own rows, "
            "where the reference takes the global batch (ROADMAP A9 (j))")
    rules = mesh_rules_for(cfg, mesh, shape)
    rules.fsdp = False
    if d > 1 and shape is not None and "data" not in _entry_axes(rules.rules["batch"]):
        raise ValueError(f"a global batch of {shape.global_batch} rows does not split over "
                         f"data {d}")
    split = _model_split(cfg, mesh, rules)
    return TrainPlan(tp=TensorParallel(size=n, rank=0, **split), dp=DataParallel(size=d),
                     rules=rules, mesh=mesh)


def mesh_train_plan(cfg: ModelConfig, mesh, shape: ShapeSpec | None = None) -> TrainPlan:
    """train_plan for this process's rank of a DeviceMesh."""
    plan = train_plan(cfg, mesh, shape)
    names = axis_names(mesh)
    tp, dp = plan.tp, plan.dp
    if "model" in names:
        tp = dataclasses.replace(tp, rank=mesh.get_local_rank("model"),
                                 group=mesh.get_group("model"))
    if "data" in names:
        dp = DataParallel.on_axis(mesh)
    return dataclasses.replace(plan, tp=tp, dp=dp)
