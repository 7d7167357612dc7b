"""Serve a small LM through the continuous-batching slot engine (port of
examples/serve_lm.py).

Mixed-length requests arrive while decode is running; finished requests are
evicted and queued ones prefilled into the freed slots between decode steps.
repro's example serves the qwen3-8b smoke config, whose qk-norm attention
the port takes with ROADMAP A8; this one serves stablelm-3b's.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

Without ``--device`` it runs on the card, and fails where there is none.
``--interleave`` runs the prefills as slices beside the decode ticks.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import smoke_config
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--interleave", action="store_true")
    args = ap.parse_args(argv)
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    params = api.init(0, device=args.device)
    eng = ServeEngine(api, params, max_batch=8, max_len=128, temperature=0.0,
                      interleave=args.interleave)
    rng = np.random.default_rng(0)
    for _ in range(8):                            # initial wave
        plen = int(rng.choice([5, 8, 16]))        # mixed lengths
        eng.add_request(rng.integers(0, cfg.vocab, plen), max_new=12)
    t0 = time.time()
    for _ in range(4):                            # late arrivals mid-decode
        eng.step()
    for _ in range(4):
        plen = int(rng.choice([5, 8, 16]))
        eng.add_request(rng.integers(0, cfg.vocab, plen), max_new=12)
    results = eng.run()
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s, {eng.device})")
    print(f"slot utilization {eng.utilization() * 100:.1f}% over "
          f"{eng.stats['decode_steps']} decode steps ({eng.stats['evictions']} evictions, "
          f"{eng.stats['prefill_slices']} prefill slices)")
    for rid in sorted(results)[:3]:
        print(f"  req {rid}: {results[rid]}")
    return results


if __name__ == "__main__":
    main()
