"""1-bit gradient compression with error feedback, the paper's binary idea
applied to the data-parallel interconnect (port of examples/onebit_dp.py).

Trains the same small LM twice over a ``data`` axis of ranks: once with a
full-precision gradient mean (fp32-psum), once with the sign-compressed
sync and error feedback (1bit+EF, train/manual_dp.py), and shows that the
loss curves track each other while the synchronized gradient bytes drop.

    PYTHONPATH=src python -m repro_torch.examples.onebit_dp [--device cpu]

One process a rank (launch/mesh.spawn, gloo: on the card the ranks share
it); 4 ranks, 40 SGD steps at lr 0.01 on the smoke stablelm-3b config with
remat "none", as the reference. Without ``--device`` it runs on the card
and fails where there is none. ``main`` returns rank 0's losses by run.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import smoke_config
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten_like

RUNS = ("fp32-psum", "1bit+EF")
LR = 0.01


def _sgd(params, grads, opt):
    return tree_map(lambda p, g: (p.to(torch.float32) - LR * g).to(p.dtype), params,
                    grads), opt


def _fp_step(loss_fn, mesh):
    """The full-precision baseline: each rank's gradients averaged over
    ``data`` in f32 (DataParallel.mean's buckets), then SGD."""
    from repro_torch.distributed.sharding import DataParallel
    from repro_torch.train.step import value_and_grad
    dp = DataParallel.on_axis(mesh)

    def step(params, opt, err, batch):
        _, metrics, grads = value_and_grad(loss_fn, params,
                                           {k: dp.rows(v) for k, v in batch.items()})
        with torch.no_grad():
            mean = dp.mean([g.to(torch.float32) for g in tree_leaves(grads)])
            params, opt = _sgd(params, tree_unflatten_like(grads, mean), opt)
        return params, opt, err, metrics

    return step


def _rank(rank: int, world: int, steps: int, device: str) -> dict:
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.train.manual_dp import init_error_feedback, make_onebit_dp_step
    torch.set_num_threads(1)
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = smoke_config("stablelm-3b").replace(remat="none")
    api = get_model(cfg)
    mesh = make_mesh((world,), ("data",))
    steps_by_run = {RUNS[0]: _fp_step(api.loss, mesh),
                    RUNS[1]: make_onebit_dp_step(api.loss, _sgd, mesh)}
    out = {}
    for name in RUNS:
        params = api.init(0, device=dev, packed=False)
        err, opt, losses = init_error_feedback(params), {}, []
        data = SyntheticTokens(cfg.vocab, 32, 8, seed=0, noise=0.02)
        for _ in range(steps):
            batch = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
            params, opt, err, m = steps_by_run[name](params, opt, err, batch)
            losses.append(float(m["loss"]))
        out[name] = losses
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from repro_torch.launch.mesh import spawn
    from repro_torch.train.manual_dp import onebit_wire_bytes
    resolve_device(args.device)          # no card: raise here, before any rank starts
    cfg = smoke_config("stablelm-3b").replace(remat="none")
    params = get_model(cfg).init(0, device="cpu", packed=False)
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"params={n_params / 1e6:.2f}M; per-step DP sync: "
          f"bf16={2 * n_params / 2**20:.1f} MiB vs "
          f"1-bit packed={n_params / 8 / 2**20:.2f} MiB (16x); "
          f"sent here: f32 {4 * n_params / 2**20:.2f} MiB vs "
          f"int8 signs + scales {onebit_wire_bytes(params) / 2**20:.2f} MiB a rank")
    losses = spawn(_rank, args.ranks, backend="gloo", args=(args.steps, args.device),
                   timeout=900)[0]
    for name in RUNS:
        ls = losses[name]
        print(f"{name:10s} loss: {ls[0]:.3f} -> {ls[-1]:.3f} "
              f"(first 3: {['%.3f' % x for x in ls[:3]]})")
    return losses


if __name__ == "__main__":
    main()
