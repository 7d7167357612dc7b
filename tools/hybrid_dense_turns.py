#!/usr/bin/env python3
"""Time B5 (hybrid_dense) of two checkouts in turns on one NVIDIA GPU.

    python3 tools/hybrid_dense_turns.py BEFORE_DIR [AFTER_DIR]

AFTER_DIR defaults to the checkout that holds this script. Four processes
run, in the order before, after, after, before. Each imports
``repro_torch`` from its checkout's ``src`` (which builds that checkout's
``hybrid_dense.cu`` into the checkout's own ``build/``) and, at each of
chip_smoke.py's HYBRID_CASES with inputs from its seed, holds the public
wrapper ``hybrid_dense(pa, pw, scale, shift, k)`` bit for bit against
``hybrid_dense_plain`` and times it with chip_smoke.py's timer (CUDA
events, L2 flushed). It prints the card's name and power limit, then one
JSON line a case: each checkout's two times and their mean. A checkout's
package must hold every module that chip_smoke.py imports.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one_turn(tree: Path) -> dict[str, float]:
    """The checkout's kernel at every case: {case: ms}."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != tree / "src":
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, not {tree}")
    # chip_smoke.py puts its own src on the path, but repro_torch is
    # already imported: its modules come from the checkout
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    times = {}
    for name, m, n, k, signed_zero in cs.HYBRID_CASES:
        args = (*cs._hybrid_inputs(m, n, k, signed_zero, dev, gen), k)
        if not torch.equal(cs.hybrid_dense(*args), cs.hybrid_dense_plain(*args)):
            raise AssertionError(f"{tree}: hybrid_dense differs from plain at {name}")
        times[name] = timer(lambda: cs.hybrid_dense(*args))
    return times


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--turn":
        print(json.dumps(one_turn(Path(argv[1]))))
        return 0
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    trees = {"before": Path(argv[0]).resolve(),
             "after": Path(argv[1]).resolve() if len(argv) == 2 else ROOT}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    turns = {"before": [], "after": []}
    for label in ("before", "after", "after", "before"):
        run = subprocess.run([sys.executable, __file__, "--turn", str(trees[label])],
                             capture_output=True, text=True)
        if run.returncode:
            raise RuntimeError(f"the {label} turn failed:\n{run.stderr[-4000:]}")
        turns[label].append(json.loads(run.stdout.splitlines()[-1]))
    for case in turns["after"][0]:
        row = {"case": case}
        for label, runs in turns.items():
            row[f"{label}_turns_ms"] = [r[case] for r in runs]
            row[f"{label}_ms"] = statistics.mean(row[f"{label}_turns_ms"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
