"""Perf hillclimb runner (port of repro/launch/perf.py): the three
(arch x shape) pairs of repro's, each run through dry-run variants (one
hypothesis -> change -> re-trace -> re-analyse iteration a variant), with
the roofline terms printed side by side.

  PYTHONPATH=src python -m repro_torch.launch.perf --pair qwen3_train
  PYTHONPATH=src python -m repro_torch.launch.perf --all

The variants and their hypotheses are repro's; the terms are the port's
dry run's (launch/dryrun.py: the analytic roofline at the H100's peaks,
the recorder's collective bytes over NVLink and the NIC). Where the port
refuses a cell or a knob, the row says so: ``remat="dots"`` raises in the
port (models/lm_common._maybe_remat). whisper's and deepseek-v3's decode
cells lower on their model axis (A9 (f)); ``cache_update``,
``serve_cache_sharding`` and ``serve_fsdp`` have no counterpart in the
port's forward, so those rows repeat their base.
Under fake tensors ``attn_chunk`` changes only the plain attention's
blocks (B3 tiles its own), which the analytic terms do not see either.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import get_config
from repro_torch.launch.dryrun import OUT_DIR, run_cell

PERF_DIR = OUT_DIR.parent / "perf"


def _variants_qwen3_train():
    cfg = get_config("qwen3-8b")
    return "qwen3-8b", "train_4k", [
        ("base", cfg),
        # H1: replicate wk / wv over `model` (repro: GSPMD's 8-kv-head
        # projections split 16 ways mid-head; here attention then runs
        # whole on every rank)
        ("kv_replicated", cfg.replace(shard_kv_heads=False)),
        # H2: remat "dots" saves the products' outputs (refused here)
        ("remat_dots", cfg.replace(shard_kv_heads=False, remat="dots")),
        # H3: single-chunk attention at 4k -> fewer K/V re-reads (memory)
        ("attnchunk4k", cfg.replace(shard_kv_heads=False, remat="dots",
                                    attn_chunk=4096)),
        # H4: binary FFN in xnor mode during training (ablation)
        ("xnor_train", cfg.replace(shard_kv_heads=False, remat="dots",
                                   policy=cfg.policy.__class__(
                                       binary_ffn=True, edge_blocks_float=2,
                                       binary_mode="xnor"))),
    ]


def _variants_whisper_decode():
    cfg = get_config("whisper-base").replace(cache_update="dus")
    return "whisper-base", "decode_32k", [
        ("base", cfg),
        ("mask_update", cfg.replace(cache_update="mask")),
        ("auto_cache", cfg.replace(serve_cache_sharding="auto")),
        ("mesh32x8", cfg.replace(serve_mesh="32x8")),
        ("mesh32x8_xnor", cfg.replace(serve_mesh="32x8",
                                      policy=cfg.policy.__class__(
                                          binary_ffn=True,
                                          edge_blocks_float=1,
                                          binary_mode="xnor"))),
    ]


def _variants_dsv3_decode():
    cfg = get_config("deepseek-v3-671b").replace(cache_update="dus")
    return "deepseek-v3-671b", "decode_32k", [
        ("base", cfg),
        ("mask_update", cfg.replace(cache_update="mask")),
        ("no_fsdp", cfg.replace(serve_fsdp=False)),
        ("no_fsdp_xnor", cfg.replace(serve_fsdp=False,
                                     policy=cfg.policy.__class__(
                                         binary_ffn=True,
                                         edge_blocks_float=3,
                                         binary_mode="xnor"))),
        ("xnor_edge8", cfg.replace(serve_fsdp=False,
                                   policy=cfg.policy.__class__(
                                       binary_ffn=True, edge_blocks_float=8,
                                       binary_mode="xnor"))),
    ]


PAIRS = {
    "qwen3_train": _variants_qwen3_train,
    "whisper_decode": _variants_whisper_decode,
    "dsv3_decode": _variants_dsv3_decode,
}


def run_pair(name: str, multi_pod: bool = False) -> list:
    """Dry-run every variant of pair ``name`` and print the table -> its
    rows (records under PERF_DIR)."""
    arch, shape_name, variants = PAIRS[name]()
    rows = []
    for tag, cfg in variants:
        rec = run_cell(arch, shape_name, multi_pod=multi_pod, out_dir=PERF_DIR,
                       cfg_override=cfg, tag=f"__{name}__{tag}")
        if rec["status"] == "ok":
            rl = rec["roofline"]
            rows.append((tag, rl["t_compute"], rl["t_memory"],
                         rl["t_collective"], rl["bottleneck"],
                         rec["memory"]["argument_bytes"] / 2**30))
        else:
            rows.append((tag, None, None, None, rec["status"], rec["reason"]
                         if rec["status"] == "skipped" else rec["error"]))
    print(f"\n=== {name} ({arch} x {shape_name}) ===")
    print(f"{'variant':16s} {'t_comp':>10s} {'t_mem':>10s} {'t_coll':>10s} "
          f"{'bottleneck':>12s} {'args GiB/dev':>12s}")
    for tag, tc, tm, tl, bn, ab in rows:
        if tc is None:
            print(f"{tag:16s} {'—':>10s} {'—':>10s} {'—':>10s} {bn:>12s}  {ab}")
        else:
            print(f"{tag:16s} {tc:10.3e} {tm:10.3e} {tl:10.3e} {bn:>12s} "
                  f"{ab:12.2f}")
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pair", choices=list(PAIRS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    if not (args.all or args.pair):
        ap.error("--pair or --all")
    names = list(PAIRS) if args.all else [args.pair]
    return {n: run_pair(n, multi_pod=args.multi_pod) for n in names}


if __name__ == "__main__":
    main()
