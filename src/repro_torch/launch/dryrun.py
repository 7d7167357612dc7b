"""Dry run of every (arch x shape x mesh) cell on fake tensors (port of
repro/launch/dryrun.py): one rank's step, traced with no device and no
process group, recorded with its argument and peak bytes, its counted
FLOPs, its collectives and the analytic roofline at the H100's peaks.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --sweep [--multi-pod-only]

Records: build/dryrun/<arch>__<shape>__<mesh>.json (the sweep skips cells
whose record already exists: it is resumable; --no-skip-existing redoes
them).

What stands for repro's compile. repro lowers each cell with
ShapeDtypeStruct inputs on 512 fake host devices and reads GSPMD's
per-partition module. Here one rank's step runs under torch's
FakeTensorMode, on fake CPU tensors (so every kernel wrapper takes its
plain version), nothing allocated on any device:

* the meshes are launch/mesh.make_production_mesh's layout, described by
  a MeshShape with no ranks: ``nodes32x8`` (data 32 x model 8, 256 cards)
  and, with --multi-pod, ``nodes64x8`` (512 cards), the card counts of
  repro's pod16x16 and pod2x16x16;
* a training cell goes through specs.train_plan and make_train_step(plan=);
  its rank holds its shard of the latent params (specs.abstract_params cut
  by sharding.shard_shape), their AdamW moments and its rows of the batch;
* a serving cell's ``model`` axis goes through specs.serving_plan, and its
  ``data`` axis gives the rank its rows of the global batch (those that
  mesh_rules_for's batch rule splits) and no collective, as the serving
  launcher refuses a ``data`` axis, as repro's does. Its params are the
  deployed ones where the binary FFNs are quantized (repro's choice),
  else the latents; prefill runs api.prefill, decode api.decode on the
  rank's cache;
* collectives are recorded by distributed/collectives.recording, not
  issued; the peak of live bytes is tracked storage by storage
  (``LiveBytes``); FLOPs are counted by torch.utils.flop_counter.

Record keys are repro's, with ``cost.flops_counted`` in place of
``cost.flops_hlo_body_once``. The caveat is the other way round: the
counter sees every op of the step once per execution (no loop is counted
once), but it counts only products and attention (mm, bmm, addmm, SDPA
and convolutions), so B1's SWAR popcount and the elementwise work are not
in it. Memory: ``argument_bytes`` (params, moments, batch, cache of the
rank), ``peak_bytes`` (the most live at once during the step, arguments
included; the plain attention builds score blocks that B3 does not) and
``output_bytes``.

Statuses: a cell that configs.cell_is_runnable refuses, or that the port
refuses (a NotImplementedError of its own: A9 (l) for training any family
but the GQA dense one on a model axis, A9 (j) for MoE on data; or a
plan's ValueError: A9 (k) for an FFN whose shard would not hold whole
packed words, as qwen2-72b's d_ff 29568 over 8), is ``skipped`` with the
reason; anything else raised is ``error`` with its traceback. Every
family's serving cells lower (the recurrent families, whisper and the VLM
since their mesh port: a rank holds the cut specs.shard_shapes gives, e.g.
Mamba2's conv channels beside B and C whole and its in_bcdt whole).

The roofline is one card's share of the analytic step
(hlo_analysis.card_cost): a part the plan keeps whole on the ``model``
axis (MLA's down projections and compressed cache, a MoE router) counts
whole on every rank of it, a split one (the routed experts among them)
1 / ``model``; the record's ``split`` carries ``mixer`` for the recurrent
families.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from dataclasses import dataclass
from pathlib import Path

from repro_torch.configs import ARCHS, SHAPES, cell_is_runnable, get_config
from repro_torch.configs.base import ModelConfig, ShapeSpec

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = {False: ("nodes32x8", (32, 8)), True: ("nodes64x8", (64, 8))}
AXES = ("data", "model")


def production_mesh(multi_pod: bool):
    """-> (name, MeshShape) of the production layout (module note)."""
    from repro_torch.launch.mesh import MeshShape
    name, dims = MESHES[multi_pod]
    return name, MeshShape(dims, AXES)


@dataclass
class Lowered:
    """One rank's step of a cell, planned: what it holds and runs."""
    cfg: ModelConfig
    shape: ShapeSpec
    mesh: object
    api: object
    rows: int            # this rank's rows of the global batch
    tp: object           # sharding.TensorParallel of the model axis
    plan: object         # specs.TrainPlan (train) or None
    weights: str         # latent | packed | deployed
    params: object       # a tree of (shape, dtype): the rank's shards

    @property
    def n_cards(self) -> int:
        return math.prod(self.mesh.shape.values())


def _rows(cfg, shape, mesh) -> int:
    """Rows of the global batch a rank holds: mesh_rules_for's batch rule
    splits them over the axes that divide it, else each rank holds all."""
    from repro_torch.distributed.sharding import _entry_axes
    from repro_torch.launch import specs as S
    axes = _entry_axes(S.mesh_rules_for(cfg, mesh, shape).rules["batch"])
    return shape.global_batch // math.prod(mesh.shape[a] for a in axes)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, cfg_override=None,
               shape: ShapeSpec | None = None, mesh=None, weights: str | None = None):
    """-> (Lowered, mesh, cfg, shape). ``shape`` / ``mesh`` replace the
    named shape and the production mesh (a ShapeSpec and a MeshShape of
    the sizes a card runs); ``weights`` replaces the cell's params: latent
    (init(packed=False)), packed (latents and the serving copy of the sign
    words, what launch.serve serves) or deployed (models/deploy.py).
    Raises the plans' refusals."""
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import get_model
    cfg = cfg_override or get_config(arch)
    shape = shape or SHAPES[shape_name]
    serving = shape.kind != "train"
    if mesh is None:
        if serving and cfg.serve_mesh and not multi_pod:
            mesh = MeshShape([int(x) for x in cfg.serve_mesh.split("x")], AXES)
        else:
            mesh = production_mesh(multi_pod)[1]
    api = get_model(cfg)
    if serving:
        model_mesh = MeshShape((mesh.shape.get("model", 1),), ("model",))
        tp, rules = S.serving_plan(cfg, model_mesh)
        plan, spec_mesh = None, model_mesh
        rows = _rows(cfg, shape, mesh)
        if weights is None:
            quantized = cfg.policy.binary_ffn and cfg.policy.binary_mode != "bf16"
            weights = "deployed" if quantized else "latent"
    else:
        plan = S.train_plan(cfg, mesh, shape)
        tp, rules, spec_mesh = plan.tp, plan.rules, mesh
        rows = shape.global_batch // plan.dp.size
        weights = weights or "latent"
    p_abs = S.abstract_params(api, deployed=weights == "deployed", packed=weights == "packed")
    params = S.shard_shapes(api, p_abs, spec_mesh, rules)
    return (Lowered(cfg=cfg, shape=shape, mesh=mesh, api=api, rows=rows, tp=tp, plan=plan,
                    weights=weights, params=params), mesh, cfg, shape)


class LiveBytes:
    """A dispatch mode that tracks the bytes of every storage an op
    creates until it is freed -> ``live``, and the most at once,
    ``peak``. Fake tensors have storages (with no memory), so the count is
    what a device would hold, before its allocator's rounding."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        tracker = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                tracker.track(out)
                return out
        self.mode = _Mode()
        self.live = self.peak = 0
        self._seen: dict[int, weakref.finalize] = {}

    def track(self, tree) -> None:
        import torch
        from torch.utils._pytree import tree_leaves
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._seen:
                continue
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            self._seen[key] = weakref.finalize(st, self._free, key, n)

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._seen.pop(key, None)

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def tree_nbytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    import torch
    from torch.utils._pytree import tree_leaves
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def trace_step(low: Lowered) -> dict:
    """Run ``low``'s step once on fake tensors -> {"flops_counted",
    "collectives", "memory", "trace_s"}."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.distributed.collectives import recording
    from repro_torch.distributed.sharding import tensor_parallel
    from repro_torch.launch import specs as S
    from repro_torch.optim import adamw_init
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import tree_map
    cfg, shape, api = low.cfg, low.shape, low.api
    t0 = time.perf_counter()
    with FakeTensorMode(), LiveBytes() as live:
        args = {"params": tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1]), low.params)}
        if shape.kind == "decode":
            with tensor_parallel(low.tp):
                args["cache"] = api.init_cache(low.rows, shape.seq_len, "cpu")
            args["batch"] = {"tokens": torch.zeros((low.rows, 1), dtype=torch.int32)}
        else:
            meta = S.make_lm_batch_specs(cfg, ShapeSpec(shape.name, shape.seq_len, low.rows,
                                                        shape.kind))
            args["batch"] = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in meta.items()}
            if shape.kind == "prefill":
                del args["batch"]["labels"]
        if shape.kind == "train":
            args["opt"] = adamw_init(args["params"],
                                     moment_dtype=getattr(torch, cfg.opt_moment_dtype))
        arg_bytes = {k: tree_nbytes(v) for k, v in args.items()}
        live.peak = live.live
        flops = FlopCounterMode(display=False)
        with recording() as rec, flops:
            if shape.kind == "train":
                step = make_train_step(api, cfg, plan=low.plan)
                out = step(args["params"], args["opt"], args["batch"])
            else:
                with torch.no_grad(), tensor_parallel(low.tp):
                    if shape.kind == "prefill":
                        out = api.prefill(args["params"], args["batch"])
                    else:
                        out = api.decode(args["params"], args["cache"], args["batch"]["tokens"])
        memory = {"argument_bytes": sum(arg_bytes.values()),
                  **{f"{k}_bytes": v for k, v in arg_bytes.items()},
                  "output_bytes": tree_nbytes(out), "peak_bytes": live.peak}
        memory["temp_bytes"] = memory["peak_bytes"] - memory["argument_bytes"]
    return {"flops_counted": float(flops.get_total_flops()), "collectives": rec.summary(),
            "memory": memory, "trace_s": time.perf_counter() - t0}


def _refusal(e: BaseException) -> bool:
    """One of the port's refusals: a NotImplementedError this package
    raises, or a ValueError of the plans (launch/specs.py: a shape the
    mesh cannot split)."""
    tb = e.__traceback__
    while tb is not None and tb.tb_next is not None:
        tb = tb.tb_next
    mod = "" if tb is None else tb.tb_frame.f_globals.get("__name__", "")
    return (isinstance(e, NotImplementedError) and mod.startswith("repro_torch.")) or \
        (isinstance(e, ValueError) and mod == "repro_torch.launch.specs")


def _dump(rec: dict, out_path) -> None:
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             out_dir=OUT_DIR, cfg_override=None, tag: str = "",
             shape: ShapeSpec | None = None, mesh=None, weights: str | None = None) -> dict:
    """Plan, trace and record one cell -> its record, also written to
    out_dir (None: not written). ``shape``, ``mesh`` and ``weights``:
    lower_cell's; a given mesh is named by its sizes ("data2xmodel1")."""
    from repro_torch.distributed import hlo_analysis
    if mesh is None:
        mesh_name = production_mesh(multi_pod)[0]
    else:
        mesh_name = "x".join(f"{a}{n}" for a, n in mesh.shape.items())
    cell = f"{arch}__{shape_name}__{mesh_name}{tag}"
    out_path = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        out_path = os.path.join(out_dir, cell + ".json")
    cfg = cfg_override or get_config(arch)
    shape = shape or SHAPES[shape_name]
    runnable, reason = cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
           "tag": tag}
    if not runnable:
        rec.update({"status": "skipped", "reason": reason})
        if out_path:
            _dump(rec, out_path)
        print(f"[dryrun] SKIP {cell}: {reason}")
        return rec

    t0 = time.time()
    try:
        low, mesh, cfg, shape = lower_cell(arch, shape_name, multi_pod=multi_pod,
                                           cfg_override=cfg_override, shape=shape, mesh=mesh,
                                           weights=weights)
        t_lower = time.time() - t0
        traced = trace_step(low)
        split = {"attn": low.tp.attn, "ffn": low.tp.ffn, "vocab": low.tp.vocab,
                 "experts": low.tp.experts}
        if cfg.family in ("mamba2_hybrid", "rwkv6"):
            split["mixer"] = low.tp.mixer
        stats = hlo_analysis.analyze_step(traced, cfg=cfg, shape=shape,
                                          data=shape.global_batch // low.rows,
                                          model=mesh.shape.get("model", 1), split=split)
        mflops = hlo_analysis.model_flops(cfg, shape)
        a = stats["analytic"]
        total_analytic = a["flops_bf16"] + a["flops_int8"] + a["flops_xnor"]
        rec.update({
            "status": "ok",
            "n_chips": low.n_cards,
            "mesh_shape": dict(mesh.shape),
            "rows_per_card": low.rows,
            "weights": low.weights,
            "split": split,
            "lower_s": round(t_lower, 1),
            "trace_s": round(traced["trace_s"], 1),
            "model_flops_step": mflops,
            "useful_flops_ratio": (mflops / total_analytic if total_analytic else None),
            "param_count": hlo_analysis.param_count(cfg),
            "param_count_active": hlo_analysis.param_count(cfg, active_only=True),
            **stats,
        })
        rl = stats["roofline"]
        print(f"[dryrun] OK   {cell}  lower={t_lower:.0f}s trace={traced['trace_s']:.0f}s "
              f"t_comp={rl['t_compute']:.2e} t_mem={rl['t_memory']:.2e} "
              f"t_coll={rl['t_collective']:.2e} bottleneck={rl['bottleneck']}")
    except Exception as e:  # noqa: BLE001
        if _refusal(e):
            rec.update({"status": "skipped", "reason": str(e)})
            print(f"[dryrun] SKIP {cell}: {e}")
        else:
            rec.update({"status": "error", "error": repr(e),
                        "traceback": traceback.format_exc()[-4000:]})
            print(f"[dryrun] FAIL {cell}: {e!r}")
    if out_path:
        _dump(rec, out_path)
    return rec


def sweep(*, multi_pod_values=(False, True), out_dir=OUT_DIR, only_arch=None,
          skip_existing=True) -> list[dict]:
    """Every (arch, shape, mesh) cell, in order. The cells not yet recorded
    trace in parallel, one process each, as many at a time as this process
    may use cores (a trace is one Python thread's work: rwkv6's prefill_32k
    runs its WKV loop token by token); their configs are resolved here."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    cells = []
    for arch in ARCHS:
        if only_arch and arch != only_arch:
            continue
        # smallest-first within arch: decode < prefill < train
        for shape_name in ("decode_32k", "long_500k", "prefill_32k", "train_4k"):
            for mp in multi_pod_values:
                cells.append((arch, shape_name, mp))
    results: list = [None] * len(cells)
    todo = []
    for i, (arch, shape_name, mp) in enumerate(cells):
        mesh_name = production_mesh(mp)[0]
        out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}.json")
        if skip_existing and os.path.exists(out_path):
            with open(out_path) as f:
                rec = json.load(f)
            if rec.get("status") in ("ok", "skipped"):
                print(f"[dryrun] CACHED {arch}__{shape_name}__{mesh_name} ({rec['status']})")
                results[i] = rec
                continue
        todo.append(i)
    if todo:
        n = min(len(os.sched_getaffinity(0)), len(todo))
        with ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("spawn")) as ex:
            futures = {i: ex.submit(run_cell, cells[i][0], cells[i][1], multi_pod=cells[i][2],
                                    out_dir=out_dir, cfg_override=get_config(cells[i][0]))
                       for i in todo}
            for i, fut in futures.items():
                results[i] = fut.result()
    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    er = sum(r["status"] == "error" for r in results)
    print(f"[dryrun] sweep done: {ok} ok, {sk} skipped, {er} errors")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR))
    ap.add_argument("--no-skip-existing", action="store_true")
    args = ap.parse_args(argv)
    if args.sweep:
        mp = (False, True)
        if args.single_pod_only:
            mp = (False,)
        if args.multi_pod_only:
            mp = (True,)
        return sweep(multi_pod_values=mp, out_dir=args.out_dir, only_arch=args.arch,
                     skip_existing=not args.no_skip_existing)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --sweep")
    return run_cell(args.arch, args.shape, multi_pod=args.multi_pod, out_dir=args.out_dir)


if __name__ == "__main__":
    main()
