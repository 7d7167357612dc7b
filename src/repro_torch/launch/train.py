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
loss, grad_norm, lr, step_s). ``--mesh`` (data and model parallel
training) is ROADMAP A9 (c).
"""

from __future__ import annotations

import argparse
import logging
import statistics
import time

import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as C
from repro_torch.train.fault_tolerance import TrainSupervisor
from repro_torch.train.step import make_train_step

log = logging.getLogger("repro_torch.train")


def main(argv=None):
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
                    help="data / model parallel mesh (not ported: ROADMAP A9 (c))")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.mesh:
        raise NotImplementedError("--mesh: sharded training is not ported yet (ROADMAP A9 (c): "
                                  "data-parallel training with the 1-bit sync)")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = get_model(cfg)
    device = resolve_device(args.device)
    params = api.init(0, device=device, packed=False)
    opt = adamw_init(params, moment_dtype=getattr(torch, cfg.opt_moment_dtype))
    data = SyntheticTokens(cfg.vocab, args.seq, args.batch, seed=0)

    start_step = 0
    if args.resume and args.ckpt_dir:
        last = C.latest_step(args.ckpt_dir)
        if last is not None:
            restored, meta = C.restore(args.ckpt_dir, last, {"params": params, "opt": opt})
            params, opt = restored["params"], restored["opt"]
            del restored
            data.restore(meta["data_state"])
            start_step = meta["step"]
            log.info("resumed from step %d", start_step)

    step_fn = make_train_step(api, cfg, peak_lr=args.lr, warmup=max(args.steps // 20, 1),
                              total=args.steps)

    def checkpoint_fn(state, i):
        if not args.ckpt_dir:
            return
        params, opt = state
        C.save_async(args.ckpt_dir, start_step + max(i, 0), {"params": params, "opt": opt},
                     meta={"data_state": data.state()})

    def wrapped_step(params, opt, batch):
        batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        return step_fn(params, opt, batch)

    sup = TrainSupervisor(wrapped_step, checkpoint_fn=checkpoint_fn)
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
                 "on %s", history[-1]["loss"], len(history), dt,
                 statistics.median(h["step_s"] for h in history),
                 sup.watchdog.straggler_steps,
                 torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    if args.ckpt_dir:
        checkpoint_fn((params, opt), len(history))
        C.wait_for_saves()                     # join async writers before exit
    return history


if __name__ == "__main__":
    main()
