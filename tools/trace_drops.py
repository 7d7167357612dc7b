#!/usr/bin/env python3
"""Where a CUDA-only torch.profiler trace of an eager full-width run loses
kernel records, on one NVIDIA GPU.

    python3 tools/trace_drops.py [--trials N] [--pad spin|add]

zamba2-2.7b at full width and depth (chip_smoke.py's seed, bf16, its state
path) serves the longest group of chip_smoke.py's prompts through the
bucket engine, traced with CUDA activity only as chip_smoke.py's recurrent
phase traces it, N times (default 8) in each of two ways, alternating:
"plain", the run and its device sync; "pad", the same and then, still
inside the trace, chip_smoke.trace_pad (4,096 spin kernels of
torch.cuda._sleep and a second sync), as chip_smoke.py ends every trace;
with "--pad add", 4,096 in-place adds on one element instead. It prints
the card's name and power limit, then a JSON line a trial: the wrappers'
counts and the trace's kernel events per family of ours, and where the
trace's sequence of our kernels (by start time) departs from the longest
such sequence of all trials: the lengths of their common prefix and
suffix. A trace that lost records only at its end has a common prefix as
long as itself.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _ours(prof, cs) -> list[str]:
    """Our kernels' families in the trace, in the order they started."""
    from torch.autograd import DeviceType
    fams = set(cs.OUR_KERNELS.values())
    evts = [e for e in prof.events()
            if e.device_type == DeviceType.CUDA and cs._kernel_family(e.name) in fams]
    return [cs._kernel_family(e.name) for e in sorted(evts, key=lambda e: e.time_range.start)]


def _common(a: list, b: list) -> tuple[int, int]:
    pre = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    suf = next((i for i, (x, y) in enumerate(zip(reversed(a), reversed(b))) if x != y),
               min(len(a), len(b)))
    return pre, suf


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--pad", choices=("spin", "add"), default="spin")
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("trace_drops: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0], flush=True)
    cfg = cs.get_config("zamba2-2.7b")
    api = cs.get_model(cfg)
    params = api.init(cs.SEED, device=dev)
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(cs.PROMPT_LENS)))
               for _ in range(cs.N_REQUESTS)]
    longest = max(len(p) for p in prompts)
    group = [p for p in prompts if len(p) == longest]
    cs._bucket_once(api, params, group)                  # warm: build, allocator
    pad = torch.zeros(1, device=dev)
    trials = []
    for i in range(2 * args.trials):
        how = ("plain", "pad")[i % 2]
        cs.zero_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cs._bucket_once(api, params, group)
            if how == "pad" and args.pad == "spin":
                cs.trace_pad()
            elif how == "pad":
                for _ in range(cs.TRACE_PAD):
                    pad.add_(1)
                torch.cuda.synchronize()
        trials.append(dict(trial=i, how=how, counts=cs._by_family(cs.counts()),
                           events=cs._device_launches(prof), seq=_ours(prof, cs)))
        del prof
    ref = max((t["seq"] for t in trials), key=len)
    for t in trials:
        seq = t.pop("seq")
        pre, suf = _common(seq, ref)
        lost = {f: n - t["events"].get(f, 0) for f, n in t["counts"].items() if n}
        print(json.dumps(dict(t, ours=len(seq), longest=len(ref), common_prefix=pre,
                              common_suffix=suf, lost=lost)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
