"""Serving launcher: random-init a registered LM on the card and run a batch
of requests through the continuous-batching slot engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b \\
      --requests 12 --prompt-lens 16,48,100,128 --max-new 16

``--smoke`` takes the arch's small config; ``--device cpu`` runs on the CPU
(the CUDA kernels then run their plain versions). Without ``--device`` it
runs on the card, and fails where there is none. ``--kv-cache`` picks the
pool's codec (bf16, int8, binary), ``--kv-block-size`` the paged pool and
``--prefix-cache`` the radix prefix cache over it. ``--temperature`` and
``--seed`` sample from each request's own stream; ``--spec-decode K``
drafts K tokens a wave through the binarized self-draft and verifies them
in one float pass (``--spec-draft-impl`` picks the draft's packed
product). ``--init-seed`` seeds the random weights and the prompts.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.kernels.ops import SPEC_DRAFT_IMPLS
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeEngine

log = logging.getLogger("repro_torch.serve")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-lens", default="16",
                    help="comma-separated prompt lengths to draw from")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="engine sampling seed (temperature > 0)")
    ap.add_argument("--init-seed", type=int, default=0,
                    help="seed of the random init and of the prompts")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decoding: draft K tokens per wave through the "
                         "binarized self-draft and verify them in one float pass (0 = off)")
    ap.add_argument("--spec-draft-impl", default=None, choices=list(SPEC_DRAFT_IMPLS),
                    help="packed product of the binary draft: auto / xla_xnor / "
                         "pallas_xnor = B1 (XNOR-popcount), int8_mxu = B2 (+-1 int8); "
                         "exact integers either way, so tokens never change")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--kv-cache", default=None, choices=["auto", "bf16", "int8", "binary"],
                    help="KV-cache codec override (see serving/kvcache.py)")
    ap.add_argument("--kv-block-size", type=int, default=0,
                    help="paged KV pool block size in tokens (0 = slot-contiguous pool)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the paged pool "
                         "(requires --kv-block-size > 0)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = get_model(cfg)
    params = api.init(args.init_seed, device=args.device)
    plens = [int(x) for x in args.prompt_lens.split(",")]
    eng = ServeEngine(api, params, max_batch=args.max_batch,
                      max_len=max(plens) + args.max_new + 8 + args.spec_decode,
                      kv_cache=args.kv_cache, kv_block_size=args.kv_block_size,
                      prefix_cache=args.prefix_cache, temperature=args.temperature,
                      seed=args.seed, spec_k=args.spec_decode,
                      spec_draft_impl=args.spec_draft_impl)
    rng = np.random.default_rng(args.init_seed)
    for _ in range(args.requests):
        plen = int(rng.choice(plens))
        eng.add_request(rng.integers(0, cfg.vocab, plen), max_new=args.max_new)
    t0 = time.perf_counter()
    results = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    toks = sum(len(v) for v in results.values())
    log.info("served %d requests, %d tokens in %.3fs (%.1f tok/s) on %s",
             len(results), toks, dt, toks / max(dt, 1e-9),
             torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
             else "cpu")
    log.info("slot utilization %.1f%%, stats %s", eng.utilization() * 100, eng.stats)
    if eng.spec_k:
        log.info("speculative: k=%d, acceptance %.1f%% (%d/%d drafts), %d waves",
                 eng.spec_k, eng.acceptance_rate() * 100, eng.stats["spec_accepted"],
                 eng.stats["spec_drafted"], eng.stats["spec_waves"])
    for rid in sorted(results)[:4]:
        log.info("request %d -> %s", rid, results[rid])
    return results


if __name__ == "__main__":
    main()
