#!/usr/bin/env python3
"""Whether rwkv6's f32 logits on a `model` mesh of two ranks part from one
device's only through c_v's row-parallel partials, on one NVIDIA GPU.

    python3 tools/rwkv6_split_rounding.py [--seeds 0,1,2,3] [--layers 1,2]
    python3 tools/rwkv6_split_rounding.py --smoke --device cpu   # a quick CPU run

rwkv6-3b at full width with float FFNs in f32, as chip_smoke.py's phase 6h
checks its f32 logits, cut to each of --layers blocks; the weights and
8 x 64 prompt tokens come from each seed (seed 0 is 6h's own input). Two
gloo ranks share the card. Each (seed, depth) prefills four ways:

  whole    one device, as served;
  split    one device, c_v's product taken as the two ranks' K / 2 partial
           products summed in f32, the order in which the mesh sums them;
  mesh     the mesh as served (c_v row-parallel: each rank's partial
           product, summed by one all_reduce);
  mesh_cv  the same mesh with c_v applied whole: its input's columns
           gathered (exactly) and the whole c_v weight, a change made here
           only.

RWKV6's time-mix rounds its products' inputs to bf16 whatever the config
says (models/rwkv6.py, as repro), so an f32 difference in the residual
stream can flip a rounding in the next block. If the mesh's only departure
from one device is c_v's sum order, mesh reads like split against whole,
and mesh_cv and mesh against split read near f32 rounding.

It prints the card's name and power limit, then one JSON line for each
(seed, depth): max |a - whole| / max |whole| over the vocab for split,
mesh and mesh_cv, and max |mesh - split| / max |whole| as mesh_vs_split.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def _rank(rank: int, world: int, job: dict) -> list[dict]:
    import numpy as np
    import torch
    from repro_torch.configs import PrecisionPolicy, get_config, smoke_config
    from repro_torch.distributed.sharding import scoped_api
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh, rank_device
    from repro_torch.models import get_model
    from repro_torch.models import lm_common as lc
    from repro_torch.models import rwkv6

    dev = rank_device(rank, job["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh((world,), ("model",))
    base = smoke_config("rwkv6-3b") if job["smoke"] else get_config("rwkv6-3b")
    served_c_v = rwkv6.c_v

    def split_c_v(p, k, cfg):
        """One device: c_v as the ranks' partial products, summed in f32."""
        w, n = p["c_v"]["w"], k.shape[-1] // world
        y = sum(k[..., r * n:(r + 1) * n].reshape(-1, n).to(torch.float32)
                @ w[r * n:(r + 1) * n].to(torch.float32) for r in range(world))
        y = y.to(lc.cdt(cfg)).reshape(*k.shape[:-1], -1)
        return y + p["c_v"]["b"].to(y.dtype) if "b" in p["c_v"] else y

    rows = []
    for seed in job["seeds"]:
        for layers in job["layers"]:
            cfg = base.replace(n_layers=layers, policy=PrecisionPolicy(),
                               compute_dtype="float32", param_dtype="float32")
            api = get_model(cfg)
            batch = {"tokens": torch.as_tensor(np.random.default_rng(seed).integers(
                0, cfg.vocab, (8, 64)), device=dev)}
            params = api.init(seed, device=dev)
            v = cfg.vocab
            with torch.no_grad():
                got = {"whole": api.prefill(params, batch, max_len=256)[0][:, :v]}
                rwkv6.c_v = split_c_v
                try:
                    got["split"] = api.prefill(params, batch, max_len=256)[0][:, :v]
                finally:
                    rwkv6.c_v = served_c_v
                tp, rules = specs.mesh_tensor_parallel(cfg, mesh)
                local = specs.shard_params(api, params, mesh, tp, rules)
                whole_c_v = {id(lb): wb["c_v"] for lb, wb in zip(local["blocks"],
                                                                 params["blocks"])}

                def gathered_c_v(p, k, cfg):
                    """The mesh: c_v's input gathered, the whole weight."""
                    ffn = lc.split_tp("ffn")
                    return rwkv6._dense_or_bin(whole_c_v[id(p)], ffn.gather_last(k), cfg)
                sapi = scoped_api(api, tp)
                got["mesh"] = sapi.prefill(local, batch, max_len=256)[0][:, :v]
                rwkv6.c_v = gathered_c_v
                try:
                    got["mesh_cv"] = sapi.prefill(local, batch, max_len=256)[0][:, :v]
                finally:
                    rwkv6.c_v = served_c_v
            scale = float(got["whole"].abs().max())

            def rel(a, b):
                return float((got[a] - got[b]).abs().max()) / scale
            rows.append(dict(rank=rank, seed=seed, layers=layers,
                             split=rel("split", "whole"), mesh=rel("mesh", "whole"),
                             mesh_cv=rel("mesh_cv", "whole"),
                             mesh_vs_split=rel("mesh", "split"),
                             same_argmax=bool(torch.equal(got["mesh"].argmax(-1),
                                                          got["whole"].argmax(-1)))))
            del params, local, got, whole_c_v
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3")
    ap.add_argument("--layers", default="1,2")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true", help="rwkv6-3b's smoke config")
    args = ap.parse_args()
    from repro_torch.launch.mesh import spawn
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip(), flush=True)
    job = dict(smoke=args.smoke, device=args.device,
               seeds=[int(s) for s in args.seeds.split(",")],
               layers=[int(n) for n in args.layers.split(",")])
    ranks = spawn(_rank, 2, backend="gloo", args=(job,), timeout=1200)
    for rows in zip(*ranks):
        print(json.dumps(dict(rows[0], rank=None,
                              **{k: [r[k] for r in rows]
                                 for k in ("split", "mesh", "mesh_cv", "mesh_vs_split")})),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
