"""Training launcher (port of repro/launch/train.py).

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \\
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--resume]

Composes: the synthetic token stream -> the train step (AdamW, the latent
clip; data/synthetic.py, train/step.py) -> the fault-tolerance supervisor
(SIGTERM drain, retries, straggler watchdog) -> async checkpoints of the
params, the optimizer state and the data stream's position, which
``--resume`` restores. ``--smoke`` takes the arch's small config. It runs
on the card (B2 in every binary FFN forward, B3 in every attention
forward, each again in the recompute of ``remat="block"``), and fails
where there is none; ``--device cpu`` runs it on the CPU, where the
kernels run their plain versions:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 6 --device cpu

``main(argv)`` returns the history: one dict of floats a step (ce, aux,
loss, grad_norm, lr, step_s).

``--mesh DxM:data,model`` trains on a mesh, as the reference parses it:
one process a rank (launch/mesh.spawn; ``--backend`` nccl, a card a rank,
the default on cuda, or gloo, the default on cpu, whose ranks may share a
card). ``model`` splits the forward as tensor-parallel serving does (the
GQA dense family), ``data`` splits each global batch's rows (not for
configs with MoE layers, ROADMAP A9 (j)); every rank
draws the same global batch from the stream and takes its rows, so a mesh
run sees the single device's data and data state. Rank 0 logs, writes the
checkpoints (the shards gathered: the single device's format, restored
under any mesh) and returns the history; a rank that fails ends the run.
On a mesh a failed step is not retried and SIGTERM is not drained (a
retry or a drain on one rank would leave the others in a collective).

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 --device cpu \\
      --mesh 1x2:data,model
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import statistics
import sys
import time

import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import BACKENDS
from repro_torch.models import get_model
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as C
from repro_torch.train.fault_tolerance import TrainSupervisor
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_map

log = logging.getLogger("repro_torch.train")


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=ARCHS[0],
                    help=f"one of {ARCHS} (whisper-base and llama-3.2-vision-11b "
                         "need frames / patches, which the synthetic stream does not "
                         "give, as in repro)")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--mesh", default="",
                    help="e.g. '2x2:data,model': a data x model mesh, one process a rank "
                         "(default: one device, no ranks); model > 1 takes the GQA dense "
                         "family")
    ap.add_argument("--backend", default=None, choices=list(BACKENDS),
                    help="process group of --mesh: nccl (a card per rank; the default on "
                         "cuda) or gloo (the default on cpu; ranks may share a card)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    return ap


def parse_mesh(spec: str) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """'2x4:data,model' -> ((2, 4), ("data", "model"))."""
    try:
        shape_s, axes_s = spec.split(":")
        shape = tuple(int(x) for x in shape_s.split("x"))
    except ValueError:
        raise ValueError(f"--mesh {spec!r}: expected e.g. '2x4:data,model'") from None
    axes = tuple(axes_s.split(","))
    if len(shape) != len(axes) or min(shape) < 1:
        raise ValueError(f"--mesh {spec!r}: one positive size per axis")
    return shape, axes


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if not args.mesh:
        return _train(args, resolve_device(args.device))
    from repro_torch.launch.mesh import MeshShape, spawn
    resolve_device(args.device)          # no card: raise here, before any rank starts
    shape, axes = parse_mesh(args.mesh)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    # refused here, before any rank starts: the family, the split shapes
    # and the batch
    S.train_plan(cfg, MeshShape(shape, axes), ShapeSpec("cli", args.seq, args.batch, "train"))
    backend = args.backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
    argv = list(sys.argv[1:] if argv is None else argv)
    return spawn(_mesh_rank, math.prod(shape), backend=backend, args=(argv,),
                 timeout=3600)[0]


def _mesh_rank(rank: int, world: int, argv: list):
    """One rank of --mesh: the same run on its shard and its rows."""
    from repro_torch.launch.mesh import make_mesh, rank_device
    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO if rank == 0 else logging.WARNING)
    device = rank_device(rank, args.device)
    if device.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))   # ranks share the host
    return _train(args, device, mesh=make_mesh(*parse_mesh(args.mesh)))


def _train(args, device, mesh=None):
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = get_model(cfg)
    moment_dtype = getattr(torch, cfg.opt_moment_dtype)
    plan = None
    if mesh is not None:
        plan = S.mesh_train_plan(cfg, mesh, ShapeSpec("cli", args.seq, args.batch, "train"))
    rank0 = mesh is None or mesh.get_rank() == 0
    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, seed=0)

    start_step = 0
    last = C.latest_step(args.ckpt_dir) if args.resume and args.ckpt_dir else None
    if last is not None:
        # read whole on the host into a like tree of fake tensors (shapes
        # and dtypes only), then the whole tree, or this rank's shard of
        # it, goes to the device
        def whole():
            p = api.init(0, device="cpu", packed=False)
            return {"params": p, "opt": adamw_init(p, moment_dtype=moment_dtype)}
        restored, meta = C.restore(args.ckpt_dir, last, S.abstract(whole))
        if plan is not None:
            restored = plan.shard(api, restored)
        params, opt = (tree_map(lambda x: x.to(device), restored[k]) for k in ("params", "opt"))
        del restored
        data.restore(meta["data_state"])
        start_step = meta["step"]
        log.info("resumed from step %d", start_step)
    else:
        params = api.init(0, device=device, packed=False)
        if plan is not None:
            params = plan.shard(api, params)   # the whole tree is freed here
        opt = adamw_init(params, moment_dtype=moment_dtype)

    step_fn = make_train_step(api, cfg, peak_lr=args.lr, warmup=max(args.steps // 20, 1),
                              total=args.steps, plan=plan)

    def checkpoint_fn(state, i):
        if not args.ckpt_dir:
            return
        params, opt = state
        tree = {"params": params, "opt": opt}
        if plan is not None and plan.dp.rank == 0:
            # the replicas over data are equal: the first one's model
            # group gathers its shards to rank 0's host, which writes
            tree = plan.gather(api, tree)
        if rank0:
            C.save_async(args.ckpt_dir, start_step + max(i, 0), tree,
                         meta={"data_state": data.state()})

    def wrapped_step(params, opt, batch):
        if plan is not None:
            batch = {k: plan.dp.rows(v) for k, v in batch.items()}
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        return step_fn(params, opt, batch)

    sup = TrainSupervisor(wrapped_step, checkpoint_fn=checkpoint_fn,
                          max_retries=2 if mesh is None else 0)
    if mesh is None:
        sup.install_signals()

    # hand the state over: with no reference left here, each step frees the
    # params and moments it replaced (at full width the first ones are
    # 23 GB). A call moves its arguments into the callee's frame, so once
    # the list is emptied the supervisor holds the only reference
    handoff = [(params, opt)]
    del params, opt
    t0 = time.time()
    (params, opt), history = sup.run(handoff.pop(), data, n_steps=args.steps,
                                     ckpt_every=args.ckpt_every)
    dt = time.time() - t0
    if history:
        for i in range(0, len(history), args.log_every):
            log.info("step %d loss %.4f", start_step + i, history[i]["loss"])
        log.info("final loss %.4f  (%d steps in %.1fs, median %.3f s/step, stragglers=%d) "
                 "on %s%s", history[-1]["loss"], len(history), dt,
                 statistics.median(h["step_s"] for h in history),
                 sup.watchdog.straggler_steps,
                 torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                 "" if mesh is None else f", mesh {args.mesh}")
    if args.ckpt_dir:
        checkpoint_fn((params, opt), len(history))
        C.wait_for_saves()                     # join async writers before exit
    return history


if __name__ == "__main__":
    main()
