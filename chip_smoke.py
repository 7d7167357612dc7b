#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one output line each (or a few), every failure raising:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build: all five CUDA kernels compiled from src/repro_torch/csrc (one
     nvcc each, started together);
  3. int8: the int8-binary GEMM kernel against its plain version at the
     serving path's shapes (decode M = 8, prefill M = 8 x 128 and 8 x 256,
     bin_in (N, K) = (6912, 2560) and bin_out (2560, 6912)) and a ragged
     case, required to be exactly equal; times of the kernel, the plain
     version and one cuBLAS call on unpacked operands (torch._int_mm where
     it takes the shape, else an exact f32 torch.mm) beside the bound;
  4. flash: the flash-attention kernel against its plain version in bf16 at
     B = 8, S = T = 128, 32 heads of 80, causal, full and ragged kv_len (a
     row of length 1), S = 152, a q_offset block, GQA and head dims 64 and
     128, within bf16's tolerance of 3e-2 (tests/test_attention.py TOLS);
     times beside the bound and scaled_dot_product_attention's (with
     enable_gqa for the GQA case, on torch >= 2.5);
  5. serve: stablelm-3b at full width (32 layers, d_model 2560, bf16,
     random init from a seeded torch.Generator on the card) through
     ServeEngine(max_batch=8, max_len=256), 12 requests of 16 new tokens;
     every request gets 16 tokens in range, the kernels' launch counts are
     exactly 56 (int8) and 32 (flash, prefill only) per forward, a second
     run gives the same tokens, logits are finite and layer 0 agrees with
     the plain attention on a small batch; a third run under torch.profiler
     gives the device time by kernel and the device's busy share of the
     second run's wall time;
  6. xnor: the XNOR-popcount GEMM against its plain version, exactly, at
     the MNIST net's hidden layers (M = 1, 128, 256, 512; N = K = 1024),
     ragged K (40, 100, 384) and the spec-draft shape (8, 6912, 2560); the
     yardstick is the same cuBLAS call as int8's, on unpacked signs;
  7. hybrid_dense: the fused binary layer bit-exact at (256, 1024, 1024)
     and at ragged M; no PyTorch call computes it, so no yardstick;
  8. bf16_matmul: the bf16 GEMM within 2e-2 (tests/test_kernels.py), with
     hardtanh off and on, at (256, 1024, 512) and the MNIST float layers at
     batch 256 (fc0's K = 784, fc3's N = 10); the yardstick is torch.mm;
  9. mnist: the paper's net, the port's quickstart path: the hybrid net
     trains 2 epochs on SyntheticMnist, packs and runs packed inference,
     with the launch counts zeroed just before and read just after (B1
     exactly twice per forward); the float net trains too (no B1); both
     beat 0.6 test accuracy; packed logits through B1, through B2 and with
     latents are bitwise equal; packed inferences per second at batch 1
     and 256 (the paper's Table I protocol), warm, without an L2 flush;
 10. a JSON line of the kernels: launches on their paths (B2 and B3 in the
     serving run, B1 in the MNIST run, B5 and B6 on none), largest error,
     times and bounds;

and last, ``{"ok": true, "device": {...}}``. Without a GPU it exits non-zero
and prints no result. Kernel times are CUDA-event medians of the device's
time for one call, with the 50 MB L2 flushed before each timed call (the
serving path meets its weights cold).
Every phase's lines also go to build/chip_smoke.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hybrid_mlp as H  # noqa: E402
from repro_torch.core.binarize import pack_bits, pack_signs_int8, packed_len, unpack_bits  # noqa: E402
from repro_torch.data.synthetic import SyntheticMnist  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul, binary_matmul_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.hybrid_dense import hybrid_dense, hybrid_dense_plain  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain  # noqa: E402
from repro_torch.models import get_model, lm_common as lc  # noqa: E402
from repro_torch.nn.layers import embedding_lookup  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

KERNELS = {  # name -> wrapper; every launch count is zeroed before each path
    "int8_matmul": int8_matmul, "flash_attention": flash_attention,
    "binary_matmul": binary_matmul, "hybrid_dense": hybrid_dense,
    "bf16_matmul": bf16_matmul}

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, int8
# tensor-core ops/s, bf16 tensor-core flop/s
HBM_BPS = 3.35e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
BF16_TOL = 3e-2          # tests/test_attention.py TOLS[bfloat16]
GEMM_TOL = 2e-2          # tests/test_kernels.py, bf16_matmul
SEED = 0
OUT_DIR = Path(__file__).resolve().parent / "build"     # listed in .gitignore
RECORD: dict[str, list] = {}
# scaled_dot_product_attention takes Hq != Hkv (enable_gqa) from torch 2.5 on
SDPA_GQA = tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5)


def log(tag: str, **kw) -> None:
    RECORD.setdefault(tag, []).append(kw)
    print(f"{tag} " + json.dumps(kw), flush=True)


def counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def zero_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


class Timer:
    """Median CUDA-event time of one call, L2 flushed before each call.

    The device is held busy (torch.cuda._sleep) for twice the time the host
    takes to enqueue the call, so the start event, the call's kernels and
    the end event are all queued before the device reaches them: the
    interval is the device's time for the call, not the wrapper's Python
    time, which exceeds a small kernel's own."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device=device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 10 ** 7 / start.elapsed_time(end)

    def __call__(self, fn, reps: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        hold = int(self.cycles_per_ms * (2e3 * (time.perf_counter() - t0) + 0.05))
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(hold)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: int8-binary GEMM
# ---------------------------------------------------------------------------

def int_library(a8, pw, k, want, timer, name) -> tuple[float, str]:
    """The yardstick of the binary GEMMs: one cuBLAS call on +-1 operands
    unpacked beforehand, checked equal to the plain version, and timed."""
    m, n = a8.shape[0], pw.shape[0]
    if m > 16 and n % 8 == 0 and k % 8 == 0:          # torch._int_mm's limits
        lib_call = "torch._int_mm(int8 (M,K), int8 (K,N))"
        w8t = unpack_bits(pw, k, torch.int8).T        # (K, N) column-major
        lib = lambda: torch._int_mm(a8, w8t)          # noqa: E731
    else:
        # f32 without TF32 (torch's default) is exact here: every partial
        # sum of +-1 terms is an integer below 2**24
        lib_call = "torch.mm(f32 (M,K), f32 (K,N)), TF32 off"
        af, wft = a8.float(), unpack_bits(pw, k, torch.float32).T
        lib = lambda: torch.mm(af, wft)               # noqa: E731
    lib_err = int((lib().to(torch.int32) - want).abs().max())
    if lib_err != 0:
        raise AssertionError(f"{lib_call} differs from plain at {name}: {lib_err}")
    return timer(lib), lib_call


INT8_CASES = [  # (name, M, N, K)
    ("decode bin_in", 8, 6912, 2560),
    ("decode bin_out", 8, 2560, 6912),
    ("prefill bin_in", 1024, 6912, 2560),
    ("prefill bin_out", 1024, 2560, 6912),
    ("prefill bin_out max bucket", 2048, 2560, 6912),
    ("ragged", 5, 40, 96),
]


def phase_int8(dev, gen, timer) -> list[dict]:
    rows = []
    for name, m, n, k in INT8_CASES:
        a = pack_signs_int8(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        got, want = int8_matmul(a, pw), int8_matmul_plain(a, pw)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err != 0:
            raise AssertionError(f"int8 kernel differs from plain at {name}: {err}")
        ms = timer(lambda: int8_matmul(a, pw))
        plain_ms = timer(lambda: int8_matmul_plain(a, pw), reps=10)
        lib_ms, lib_call = int_library(a, pw, k, want, timer, name)
        b_ms, b_by = bound(m * k + n * k / 8 + 4 * m * n, 2.0 * m * n * k, INT8_OPS)
        row = dict(case=name, M=m, N=n, K=k, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_call=lib_call)
        log("int8", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 4: flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [  # (name, B, S, T, Hq, Hkv, D, q_offset, kv_len or None)
    ("full length", 8, 128, 128, 32, 32, 80, 0, None),
    ("ragged kv_len", 8, 128, 128, 32, 32, 80, 0, [128, 100, 1, 64, 17, 128, 90, 3]),
    ("S = 152", 8, 152, 152, 32, 32, 80, 0, [152, 77, 1, 152, 130, 9, 64, 151]),
    ("q_offset 128", 8, 64, 192, 32, 32, 80, 128, [192, 150, 129, 192, 170, 180, 140, 160]),
    ("GQA 8/2, D 64", 2, 96, 96, 8, 2, 64, 0, [96, 50]),
    ("D 128", 2, 96, 96, 8, 8, 128, 0, [96, 1]),
]


def _visible_pairs(s, kvl, q_offset) -> int:
    """(query, key) pairs the causal mask and kv_len leave visible."""
    return sum(min(n, i + q_offset + 1) for n in kvl for i in range(s))


def _sdpa_mask(b, s, t, kvl, q_offset, dev):
    cols = torch.arange(t, device=dev)
    rows = torch.arange(s, device=dev) + q_offset
    causal = rows[:, None] >= cols[None, :]
    lens = torch.as_tensor(kvl, device=dev)
    return (causal[None] & (cols[None, None, :] < lens[:, None, None]))[:, None]


def phase_flash(dev, gen, timer) -> list[dict]:
    rows = []
    for name, b, s, t, hq, hkv, d, off, kvl in FLASH_CASES:
        q = torch.randn(b, s, hq, d, generator=gen, device=dev).to(torch.bfloat16)
        k = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(b, t, hkv, d, generator=gen, device=dev).to(torch.bfloat16)
        lens = [t] * b if kvl is None else kvl
        kv = None if kvl is None else torch.tensor(kvl, dtype=torch.int32, device=dev)
        kw = dict(causal=True, kv_len=kv, q_offset=off)
        got = flash_attention(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not err <= BF16_TOL:
            raise AssertionError(f"flash kernel vs plain at {name}: {err} > {BF16_TOL}")
        ms = timer(lambda: flash_attention(q, k, v, **kw))
        plain_ms = timer(lambda: flash_attention_plain(q, k, v, **kw), reps=10)
        # the yardstick: one SDPA call on the same inputs (heads-major views)
        lib_ms, lib_call = None, None
        gqa = {} if hq == hkv else {"enable_gqa": True}
        if not gqa or SDPA_GQA:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            if kvl is None and off == 0 and s == t:
                lib_call = "scaled_dot_product_attention(is_causal=True)"
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, **gqa))
            else:
                lib_call = "scaled_dot_product_attention(attn_mask=bool)"
                mask = _sdpa_mask(b, s, t, lens, off, dev)
                lib_ms = timer(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, **gqa))
            if gqa:
                lib_call = lib_call[:-1] + ", enable_gqa=True)"
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4.0 * hq * d * _visible_pairs(s, lens, off)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
        row = dict(case=name, B=b, S=s, T=t, Hq=hq, Hkv=hkv, D=d, q_offset=off,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                   bound_by=b_by, library_ms=lib_ms, library_call=lib_call)
        log("flash", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 5: serve stablelm-3b at full width
# ---------------------------------------------------------------------------

N_REQUESTS, PROMPT_LENS, MAX_NEW = 12, (16, 48, 100, 128), 16


def _serve_once(api, params, prompts):
    eng = ServeEngine(api, params, max_batch=8, max_len=256)
    rids = [eng.add_request(p, max_new=MAX_NEW) for p in prompts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = eng.run()
    torch.cuda.synchronize()
    return [res[r] for r in rids], time.perf_counter() - t0, eng


def _kernel_family(name: str) -> str:
    if "int8_matmul" in name:
        return "int8_matmul (ours)"
    if "flash_fwd" in name:
        return "flash_attention (ours)"
    if any(t in name for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "float matmuls (cuBLAS)"
    return "other (elementwise, norms, copies, argmax)"


def _profile(api, params, prompts, wall_unprofiled: float) -> dict:
    """Device time by kernel over one serving run (torch.profiler; kernel
    times come from the device's own clock), and the device's busy share of
    the same work run without the profiler, whose host-side recording
    stretches the profiled run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall, _ = _serve_once(api, params, prompts)
    per_kernel = {}     # device-side events only: a CPU op's device time repeats its kernels'
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            per_kernel[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    fam: dict[str, float] = {}
    for name, (ms, _) in per_kernel.items():
        fam[_kernel_family(name)] = fam.get(_kernel_family(name), 0.0) + ms
    busy = sum(fam.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"out": out, "profiled_wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall_unprofiled * 1e3),
            "device_ms_by_family": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                            for n, (ms, c) in top]}


def phase_serve(dev, card: str) -> dict:
    cfg = get_config("stablelm-3b")
    api = get_model(cfg)
    t0 = time.perf_counter()
    params = api.init(SEED, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_binary = sum(cfg.policy.block_is_binary(i, cfg.n_layers) for i in range(cfg.n_layers))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, int(rng.choice(PROMPT_LENS)))
               for _ in range(N_REQUESTS)]

    # the main path, with the launch counts zeroed just before it
    zero_counts()
    out, wall, eng = _serve_once(api, params, prompts)
    launches = counts()
    waves, steps = eng.stats["prefills"], eng.stats["decode_steps"]
    for o in out:
        if len(o) != MAX_NEW or not all(0 <= t < cfg.vocab for t in o):
            raise AssertionError(f"bad output {o}")
    if launches["int8_matmul"] != 2 * n_binary * (waves + steps):
        raise AssertionError(f"int8 launches {launches} for {waves} prefill waves "
                             f"+ {steps} decode steps, {n_binary} binary blocks")
    if launches["flash_attention"] != cfg.n_layers * waves:
        raise AssertionError(f"flash launches {launches} for {waves} prefill waves")
    if any(launches[k] for k in ("binary_matmul", "hybrid_dense", "bf16_matmul")):
        raise AssertionError(f"the int8 LM launched another kernel: {launches}")
    out2, wall2, _ = _serve_once(api, params, prompts)
    if out2 != out:
        raise AssertionError("a second run of the same requests gave other tokens")
    prof = _profile(api, params, prompts, wall2)
    if prof.pop("out") != out:
        raise AssertionError("the profiled run gave other tokens")

    # logits finite and of the padded vocab; layer 0 (a float block) through
    # the flash kernel agrees with the plain attention on a small batch
    toks = torch.as_tensor(np.stack([np.resize(p, 48) for p in prompts[:2]]), device=dev)
    lens = torch.tensor([48, 20], dtype=torch.int32, device=dev)
    logits, _ = api.prefill(params, {"tokens": toks}, max_len=64, seq_lens=lens)
    if tuple(logits.shape) != (2, lc.padded_vocab(cfg.vocab)) or \
            not bool(torch.isfinite(logits[:, :cfg.vocab]).all()):
        raise AssertionError("prefill logits not finite / of the wrong shape")
    x = embedding_lookup(params["embed"], toks, compute_dtype=lc.cdt(cfg))
    pos = torch.arange(48, device=dev)
    sig = lc.block_sig(cfg, 0)
    outs = [lc.block_prefill(params["blocks"][0], x, cfg.replace(attn_impl=impl), sig,
                             positions=pos, max_len=64, seq_lens=lens)[0]
            for impl in ("flash", "ref")]
    layer0_err = float((outs[0].float() - outs[1].float()).abs().max())
    if not torch.allclose(outs[0].float(), outs[1].float(), rtol=BF16_TOL, atol=BF16_TOL):
        raise AssertionError(f"layer 0 flash vs plain attention: {layer0_err}")
    n_tok = sum(len(o) for o in out)
    row = dict(card=card, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               binary_blocks=n_binary, requests=N_REQUESTS, tokens=n_tok,
               prefill_waves=waves, decode_steps=steps, launches=launches,
               init_s=init_s, wall_s_first=wall, wall_s=wall2,
               tok_per_s_first=n_tok / wall, tok_per_s=n_tok / wall2,
               layer0_flash_vs_plain=layer0_err,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    log("serve", **row)
    log("profile", card=card, **prof)
    return row


# ---------------------------------------------------------------------------
# phase 6: XNOR-popcount GEMM
# ---------------------------------------------------------------------------

XNOR_CASES = [  # (name, M, N, K)
    ("mnist hidden, batch 128 (training)", 128, 1024, 1024),
    ("mnist hidden, batch 1", 1, 1024, 1024),
    ("mnist hidden, batch 256", 256, 1024, 1024),
    ("mnist hidden, batch 512 (eval)", 512, 1024, 1024),
    ("ragged K 40", 8, 24, 40),
    ("ragged K 100", 32, 48, 100),
    ("K 384, Kp 12", 64, 64, 384),
    ("spec draft bin_in", 8, 6912, 2560),
]


def phase_xnor(dev, gen, timer) -> list[dict]:
    rows = []
    for name, m, n, k in XNOR_CASES:
        pa = pack_bits(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        got, want = binary_matmul(pa, pw, k), binary_matmul_plain(pa, pw, k)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err != 0:
            raise AssertionError(f"xnor kernel differs from plain at {name}: {err}")
        ms = timer(lambda: binary_matmul(pa, pw, k))
        plain_ms = timer(lambda: binary_matmul_plain(pa, pw, k), reps=10)
        lib_ms, lib_call = int_library(unpack_bits(pa, k, torch.int8), pw, k, want,
                                       timer, name)
        kp = packed_len(k)
        b_ms, b_by = bound(4 * (m * kp + n * kp + m * n), 2.0 * m * n * k, INT8_OPS)
        row = dict(case=name, M=m, N=n, K=k, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, library_call=lib_call)
        log("xnor", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 7: fused hybrid dense
# ---------------------------------------------------------------------------

HYBRID_CASES = [  # (name, M, N, K)
    ("mnist hidden, batch 256", 256, 1024, 1024),
    ("ragged M 77", 77, 1024, 1024),
]


def phase_hybrid(dev, gen, timer) -> list[dict]:
    rows = []
    for name, m, n, k in HYBRID_CASES:
        pa = pack_bits(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        scale = torch.randn(n, generator=gen, device=dev) * 0.1 + 0.5
        shift = torch.randn(n, generator=gen, device=dev) * 0.1
        args = (pa, pw, scale, shift, k)
        got, want = hybrid_dense(*args), hybrid_dense_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hybrid_dense kernel differs from plain at {name}: "
                                 f"{int((got != want).sum())} words")
        ms = timer(lambda: hybrid_dense(*args))
        plain_ms = timer(lambda: hybrid_dense_plain(*args), reps=10)
        kp = packed_len(k)
        b_ms, b_by = bound(4 * (m * kp + n * kp + 2 * n + m * n / 32), 2.0 * m * n * k,
                           INT8_OPS)
        row = dict(case=name, M=m, N=n, K=k, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library_call="none: no single PyTorch call computes it")
        log("hybrid_dense", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 8: bf16 GEMM
# ---------------------------------------------------------------------------

BF16_CASES = [  # (name, M, N, K, hardtanh)
    ("mnist fc0, batch 256", 256, 1024, 784, False),
    ("mnist fc0, batch 256, hardtanh", 256, 1024, 784, True),
    ("mnist fc3, batch 256", 256, 10, 1024, False),
    ("mnist fc3, batch 256, hardtanh", 256, 10, 1024, True),
    ("256 x 1024 x 512", 256, 512, 1024, False),
    ("256 x 1024 x 512, hardtanh", 256, 512, 1024, True),
]


def _bf16_library(dev):
    """torch.mm on the bf16 operands, with an f32 output where the installed
    torch takes ``out_dtype`` (its CUDA mm.dtype overload)."""
    x = torch.ones(2, 2, dtype=torch.bfloat16, device=dev)
    try:
        torch.mm(x, x, out_dtype=torch.float32)
    except (TypeError, NotImplementedError, RuntimeError):
        return (lambda a, w: torch.mm(a, w)), "torch.mm(bf16, bf16) -> bf16 output"
    return ((lambda a, w: torch.mm(a, w, out_dtype=torch.float32)),
            "torch.mm(bf16, bf16, out_dtype=torch.float32)")


def phase_bf16(dev, gen, timer) -> list[dict]:
    mm, lib_call = _bf16_library(dev)
    rows = []
    for name, m, n, k, ht in BF16_CASES:
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(torch.bfloat16)
        got, want = bf16_matmul(a, w, hardtanh=ht), bf16_matmul_plain(a, w, hardtanh=ht)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=GEMM_TOL, atol=GEMM_TOL):
            raise AssertionError(f"bf16 kernel vs plain at {name}: {err}")
        lib_out = mm(a, w).float()
        if not torch.allclose(lib_out, bf16_matmul_plain(a, w), rtol=GEMM_TOL, atol=GEMM_TOL):
            raise AssertionError(f"{lib_call} vs plain at {name}")
        ms = timer(lambda: bf16_matmul(a, w, hardtanh=ht))
        plain_ms = timer(lambda: bf16_matmul_plain(a, w, hardtanh=ht), reps=10)
        lib_ms = timer(lambda: mm(a, w))
        b_ms, b_by = bound(2 * (m * k + k * n) + 4 * m * n, 2.0 * m * n * k, BF16_FLOPS)
        row = dict(case=name, M=m, N=n, K=k, hardtanh=ht, max_abs_err=err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   library_call=lib_call + (" (no clamp)" if ht else ""))
        log("bf16", **row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 9: the paper's MNIST net (the port's quickstart path)
# ---------------------------------------------------------------------------

MNIST_BATCHES = (1, 256)      # the paper's Table I
INFER_REPS = 200


def _train(hybrid: bool, data, dev) -> tuple[dict, list, float]:
    t0 = time.perf_counter()
    params = H.mlp_init(SEED, hybrid=hybrid, device=dev)
    params, accs = quickstart.train(params, data)
    torch.cuda.synchronize()
    return params, accs, time.perf_counter() - t0


def _infer_ms(fn) -> float:
    """Mean time of one call over INFER_REPS back-to-back calls, warm and
    without an L2 flush: the host's launch time counts, as it does for a
    user calling the model in a loop."""
    for _ in range(10):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(INFER_REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / INFER_REPS


def phase_mnist(dev, card: str) -> dict:
    data = SyntheticMnist(n_train=2048, n_test=512, seed=SEED)
    xt = torch.from_numpy(data.test[0]).to(dev)
    steps = quickstart.EPOCHS * (len(data.train[0]) // quickstart.BATCH)
    forwards = steps + quickstart.EPOCHS + 1       # + an eval per epoch + packed inference

    # the main path, with the launch counts zeroed just before it: train,
    # pack, packed inference through B1
    zero_counts()
    params, accs, train_s = _train(True, data, dev)
    packed = H.mlp_pack(params)
    logits = H.mlp_apply_packed(packed, xt)
    torch.cuda.synchronize()
    launches = counts()
    if launches != {**{k: 0 for k in KERNELS}, "binary_matmul": 2 * forwards}:
        raise AssertionError(f"hybrid MNIST launches {launches}, {forwards} forwards")
    if not accs[-1] > 0.6:
        raise AssertionError(f"hybrid net test accuracy {accs}")

    zero_counts()
    fparams, faccs, ftrain_s = _train(False, data, dev)
    if any(counts().values()):
        raise AssertionError(f"the float net launched a kernel: {counts()}")
    if not faccs[-1] > 0.6:
        raise AssertionError(f"float net test accuracy {faccs}")

    # exact integer dots through the same f32 BatchNorm: B1, B2 and the
    # eval-with-latents path give the same logits, bit for bit
    logits_int8 = H.mlp_apply_packed(packed, xt, mode="int8")
    logits_latent, _ = H.mlp_apply(params, xt, training=False)
    if not (torch.equal(logits, logits_int8) and torch.equal(logits, logits_latent)):
        raise AssertionError("packed logits through B1, B2 and with latents differ")
    if tuple(logits.shape) != (512, 10) or not bool(torch.isfinite(logits).all()):
        raise AssertionError("packed logits not finite / of the wrong shape")
    packed_acc = float((logits.argmax(-1).cpu() == torch.from_numpy(data.test[1])).float().mean())

    fpacked = H.mlp_pack(fparams)
    infer = {}
    for label, p in (("float", fpacked), ("hybrid", packed)):
        for b in MNIST_BATCHES:
            xb = xt[:b].contiguous()
            ms = _infer_ms(lambda: H.mlp_apply_packed(p, xb))
            infer[f"{label}_b{b}"] = {"ms": ms, "inferences_per_s": b / ms * 1e3}
    row = dict(card=card, dims=list(H.DIMS), train_steps=steps, forwards=forwards,
               launches=launches, hybrid_test_acc=accs, float_test_acc=faccs,
               hybrid_packed_test_acc=packed_acc, hybrid_train_s=train_s,
               float_train_s=ftrain_s, packed_inference=infer,
               weight_bytes={"hybrid": H.weight_memory_bytes(hybrid=True),
                             "float": H.weight_memory_bytes(hybrid=False)})
    log("mnist", **row)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log("device", torch_name=name, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)

    t0 = time.perf_counter()
    build.build_all(list(KERNELS))
    log("build", seconds=time.perf_counter() - t0, dir=str(build.BUILD_DIR))

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    int8_rows = phase_int8(dev, gen, timer)
    flash_rows = phase_flash(dev, gen, timer)
    serve = phase_serve(dev, smi)
    xnor_rows = phase_xnor(dev, gen, timer)
    hybrid_rows = phase_hybrid(dev, gen, timer)
    bf16_rows = phase_bf16(dev, gen, timer)
    del timer
    mnist = phase_mnist(dev, smi)

    def entry(kname, source, replaces, rows):
        # the headline case is the first: decode bin_in, full-length flash,
        # the MNIST hidden layer at the training batch, at batch 256, fc0
        head = rows[0]
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                # each kernel runs on one path at most; the phases checked
                # that the other path launched it no time
                "launches": serve["launches"][kname] + mnist["launches"][kname],
                "max_abs_err": max(r["max_abs_err"] for r in rows),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                "library_ms": head["library_ms"], "library_call": head["library_call"],
                "case": head["case"],
                "cases": rows}

    kernels = {"kernels": [
        entry("int8_matmul", "src/repro_torch/csrc/int8_matmul.cu",
              "src/repro/kernels/int8_matmul.py:55", int8_rows),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:118", flash_rows),
        entry("binary_matmul", "src/repro_torch/csrc/binary_matmul.cu",
              "src/repro/kernels/binary_matmul.py:69", xnor_rows),
        entry("hybrid_dense", "src/repro_torch/csrc/hybrid_dense.cu",
              "src/repro/kernels/hybrid_dense.py:54", hybrid_rows),
        entry("bf16_matmul", "src/repro_torch/csrc/bf16_matmul.cu",
              "src/repro/kernels/bf16_matmul.py:42", bf16_rows),
    ]}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({**RECORD, **kernels}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
