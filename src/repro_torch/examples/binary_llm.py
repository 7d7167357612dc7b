"""End-to-end example (port of examples/binary_llm.py): train a hybrid LM
(binary FFN hidden blocks, the BEANNA policy) on the synthetic token
stream, with checkpoints and the fault-tolerance supervisor, beside the
all-float baseline the paper compares it with.

    PYTHONPATH=src python -m repro_torch.examples.binary_llm [--steps 120] [--device cpu]

Without ``--device`` it runs on the card (B2 in every binary FFN forward
and B3 in every attention forward), and fails where there is none. For
each model it prints the analytic parameter count and deployed weight
bytes (distributed/analytic_cost.py, as the reference's example prints
them), beside both counted from the port's own tensors (models/deploy.py's
int8 weights in place of the latents), then the first and last loss.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import ModelConfig, PrecisionPolicy
from repro_torch.data.synthetic import SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.distributed import analytic_cost, hlo_analysis
from repro_torch.models import get_model
from repro_torch.models.deploy import deploy_params
from repro_torch.optim import adamw_init
from repro_torch.train import checkpoint as C
from repro_torch.train.fault_tolerance import TrainSupervisor
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves


def make_cfg(binary: bool, *, big: bool = False) -> ModelConfig:
    # --big: 42 M params (8 x d512 x ff2048, 8k vocab), sized for the card.
    # Default: 9.2 M (4 x d320 x ff1280, 4k vocab), which also runs on a CPU
    if big:
        dims = dict(n_layers=8, d_model=512, d_ff=2048, vocab=8192, n_heads=8)
    else:
        dims = dict(n_layers=4, d_model=320, d_ff=1280, vocab=4096, n_heads=5)
    return ModelConfig(
        name="binary_llm", family="dense", n_kv_heads=dims["n_heads"],
        param_dtype="float32", compute_dtype="float32", remat="none",
        attn_chunk=256,
        policy=PrecisionPolicy(binary_ffn=binary, edge_blocks_float=1,
                               binary_mode="int8"), **dims)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(params))


def train(cfg: ModelConfig, steps: int, tag: str, ckpt_dir: str, device):
    """-> (params, history) after ``steps`` steps; a checkpoint of the
    params every steps // 2 steps under ckpt_dir/tag."""
    api = get_model(cfg)
    params = api.init(0, device=device, packed=False)
    opt = adamw_init(params)
    data = SyntheticTokens(cfg.vocab, 64, 8, seed=0, noise=0.02)
    step = make_train_step(api, cfg, peak_lr=1e-3, warmup=steps // 10, total=steps)

    def wrapped(params, opt, batch):
        return step(params, opt, {k: torch.from_numpy(v).to(device) for k, v in batch.items()})

    sup = TrainSupervisor(wrapped, checkpoint_fn=lambda st, i: C.save(
        os.path.join(ckpt_dir, tag), max(i, 0), {"params": st[0]},
        meta={"data_state": data.state()}))
    (params, opt), hist = sup.run((params, opt), data, n_steps=steps,
                                  ckpt_every=max(steps // 2, 1))
    return params, hist


def main(argv=None) -> dict:
    """-> {"float" | "hybrid": {"params", "deployed_bytes", "analytic_params",
    "analytic_deployed_bytes", "history"}}."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--big", action="store_true", help="the 42 M-param variant")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "binary_llm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    out = {}
    for binary in (False, True):
        cfg = make_cfg(binary, big=args.big)
        tag = "hybrid" if binary else "float"
        params, hist = train(cfg, args.steps, tag, args.ckpt_dir, device)
        n, wb = param_count(params), weight_bytes(deploy_params(params, cfg))
        an = hlo_analysis.param_count(cfg)
        awb = analytic_cost.weight_bytes(cfg, deployed=True)
        print(f"[{tag}] params={an / 1e6:.1f}M deployed_weights={awb / 2**20:.1f} MiB "
              f"(analytic; tensors: {n / 1e6:.1f}M, {wb / 2**20:.1f} MiB)")
        print(f"[{tag}] loss: first={hist[0]['loss']:.3f} last={hist[-1]['loss']:.3f} "
              f"over {len(hist)} steps")
        out[tag] = {"params": n, "deployed_bytes": wb, "analytic_params": an,
                    "analytic_deployed_bytes": awb, "history": hist}
    return out


if __name__ == "__main__":
    main()
