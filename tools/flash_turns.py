#!/usr/bin/env python3
"""Time B3 (flash_attention) of two checkouts in turns on one NVIDIA GPU.

    python3 tools/flash_turns.py BEFORE_DIR [AFTER_DIR]

AFTER_DIR defaults to the checkout that holds this script. Four processes
run, in the order before, after, after, before. Each imports
``repro_torch`` from its checkout's ``src`` (which builds that checkout's
``flash_attention.cu`` into the checkout's own ``build/``) and, at each of
chip_smoke.py's flash cases (``ALL_FLASH_CASES``: D = Dv and MLA's
D != Dv, causal and non-causal, bf16 and f32) with inputs from its seed,
holds the public wrapper ``flash_attention`` against
``flash_attention_plain`` within chip_smoke.py's bar (``flash_err``) and
times it with chip_smoke.py's
timer (CUDA events, L2 flushed). It prints the card's name and power
limit, then one JSON line a case: each checkout's two times and their
mean. The turns are run as in tools/hybrid_dense_turns.py.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import hybrid_dense_turns as turns  # noqa: E402


def one_turn(tree: Path) -> dict[str, float]:
    """The checkout's kernel at every case: {case: ms}."""
    sys.path.insert(0, str(tree / "src"))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != tree / "src":
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}, not {tree}")
    sys.path.insert(1, str(turns.ROOT))
    import chip_smoke as cs
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    timer = cs.Timer(dev)
    times = {}
    for name, b, s, t, hq, hkv, d, dv, off, kvl, dt, causal in cs.ALL_FLASH_CASES:
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(dt)
        v = torch.randn(b, t, hkv, dv, generator=gen, device=dev).to(dt)
        kv = None if kvl is None else torch.tensor(kvl, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, kv_len=kv, q_offset=off)
        err, over = cs.flash_err(cs.flash_attention(q, k, v, **kw),
                                 cs.flash_attention_plain(q, k, v, **kw), dt)
        if not over <= 1.0:
            raise AssertionError(f"{tree}: flash_attention differs from plain at {name}: {err}")
        times[name] = timer(lambda: cs.flash_attention(q, k, v, **kw))
    return times


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--turn":
        print(json.dumps(one_turn(Path(sys.argv[2]))))
        sys.exit(0)
    sys.exit(turns.main(sys.argv[1:], script=__file__, doc=__doc__))
