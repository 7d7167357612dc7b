#!/usr/bin/env python3
"""Drive the PyTorch port (src/repro_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one output line each (or a few), every failure raising:

  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. build: the seven CUDA sources of src/repro_torch/csrc (the nine
     kernels and the dequant-fused decode), compiled with one nvcc each,
     started together; then, per kernel
     function, the registers, stack and spills that ptxas reported
     (-Xptxas=-v, in the build logs) and the count of tensor-core
     instructions (IMMA / IGMMA / HMMA / HGMMA / BMMA) in cuobjdump -sass,
     required in B2's, B3's bf16, B1's, B5's and B6's kernel functions;
  3. int8: the int8-binary GEMM kernel against its plain version at the
     serving path's shapes (decode M = 1, 8 and 16, the speculative
     verify's M = 8 x 4 = 32, prefill M = 8 x 128 and 8 x 256, bin_in
     (N, K) = (6912, 2560) and bin_out (2560, 6912)),
     a ragged case and, with activations over all of [-128, 127], a
     decode and a prefill case, required to be exactly equal; times of the
     kernel, the plain version and one cuBLAS call on unpacked operands
     (torch._int_mm where it takes the shape, else an exact f32 torch.mm)
     beside the bound; then, for the serving path's shapes, the kernel at
     every K split it takes (1, 2, 4, 8 chunks), each exact, timed beside
     the split its host plan picks (the plan's model, measured);
  4. flash: the flash-attention kernel against its plain version in bf16 at
     B = 8, S = T = 128 and 256, 32 heads of 80, causal, full and ragged
     kv_len (a row of length 1), S = 152, a q_offset block, GQA and head
     dims 64 and 128, within bf16's tolerance of 3e-2
     (tests/test_attention.py TOLS); times beside the bound and
     scaled_dot_product_attention's (with enable_gqa for the GQA case, on
     torch >= 2.5);
  5. kv_quant: the insert kernel (B4a / B4c: K and V encoded and written
     into the pool in one launch) bit for bit against its plain version
     (the encode pair, then the pool's torch scatter) at the serving shape:
     the decode insert (B 8, 32 kv heads of 80, T 256, bf16, lengths
     {144, 100, 17, 1, 0, 256, 48, 128}) on the contiguous pool and on a
     paged pool (block 16, shuffled blocks, holes, slot 4 free, len 256
     past the table's pages), every byte outside the written rows
     unchanged, the same bits on a second call, the paged rows equal to
     the contiguous ones; the prefill encode (B 8, S 128 into max_len 256,
     bf16 and f32); each timed beside the plain version, the path it
     replaced (two row-mode launches, then the torch scatter or
     zero-padding: before_ms) and the byte bound. Then the rows mode and
     the two dequantizers (B4b, B4d) at the decode insert (8, 1, 32, 80),
     the prefill encode (8, 128, 32, 80) in bf16 and f32, ragged row
     counts and D = 129 and 16, each with an all-zero row; times beside the
     byte bound (no PyTorch call computes any of them: no yardstick). The
     span insert (the speculative verify's write of S = 4 tokens a slot at
     the same lengths, clamped at T - S on the contiguous pool, through a
     table with pages up to each span's end on the paged one) is held the
     same way, bit for bit, beside its plain version and byte bound;
 5b. kv_decode: the dequant-fused decode attention (B4b's / B4d's math in
     registers) for int8 and binary on the contiguous pool and a paged pool
     (block 16, shuffled blocks, holes past each length) at B 8, T 256,
     lengths {144, 100, 17, 1, 0, 256, 48, 128}, 32 heads of 80 with bf16
     and f32 q, G 4 (Hq 32, Hkv 8), D 64 and 128: rows with len >= 1
     within 1e-4 (f32 q) / 2e-2 (bf16 q) of the plain version, len-0 rows
     zeros, the same bits on a second call and on both pools; times beside
     the plain recurrence, the earlier loop of per-block B4b / B4d
     launches, the byte bound and, as context only, SDPA over a bf16 cache
     of the same lengths; then the verify's attend with per-query lengths
     (S 4, query j below len + j + 1, bf16 q) within 2e-2, one launch a
     call, beside its plain version, bound and SDPA with the same masks;
  6. serve: stablelm-3b at full width (32 layers, d_model 2560, bf16,
     random init from a seeded torch.Generator on the card) through
     ServeEngine(max_batch=8, max_len=256), 12 requests of 16 new tokens,
     on five paths, each with the launch counts zeroed just before it and
     read just after. Each decode tick is one CUDA graph replay (one replay
     a step, checked); what a replay adds to the counts (taken from the
     wrappers' counts during the capture) must equal, per family of our
     kernels, the captured graph's kernel nodes as libcuda names
     them; the bf16 and int8 runs are also traced, and there the device's
     kernel events must equal the counts plus the graph's warm-up step.
     Each path is run twice for the same tokens and once eagerly
     (cuda_graphs=False), whose tokens must equal the replayed ones, both
     tok/s kept: the bf16 pool, the int8 and the binary pools, and,
     on prompts that share a 64-token header with the first request served
     alone before the rest, the int8 pool and a paged int8 pool (block 16)
     with the radix prefix cache. On each: every request gets 16 tokens in
     range; launches are exactly 2 x 28 per wave and per step (int8 GEMM),
     32 per wave without a cached prefix (flash), 32 per wave and per step
     of the codec's insert kernel, 32 per step of its kv_decode, 2 x 32 of
     its dequantizer per wave on a cached prefix (its context), 0 of the
     rest; the pool's bytes are exact (671,088,640
     / 343,932,928 / 58,720,256); a second run gives the same tokens; the
     paged run hits the prefix cache. Logits are finite;
     layer 0 agrees with the plain attention on a small batch, and its
     int8 and binary caches decode as their materialized copies do (2e-2).
     The traced runs of the bf16 and int8 paths, replayed (the counted run)
     and eager, give the device time by kernel and the device's busy share
     of the unprofiled wall time, with every kernel symbol of csrc mapped
     to its family (B2 and B3 must show device time in both bf16 runs, and
     kv_decode and the insert kernel in both int8 runs);
 6b. spec: the same model with spec_k = 3 (the binarized self-draft: its
     4 float FFNs x 3 matrices through B1) on five paths: bf16, int8 and
     binary contiguous greedy, paged int8 with the prefix cache on the
     header prompts, and int8 sampled (temperature 0.8, beside a plain
     sampled int8 run), each wave one graph replay whose counts are held to
     the graph's kernel nodes as in 6: every request gets 16
     tokens in range; launches exactly, per wave, B1 3 x 4 x k, B2 2 x 28
     x (k + 1), the codec's insert kernel and kv_decode 32 x (k + 1) each
     (and per prefill wave as on the plain paths); one draft launch and one
     replay a wave; a second run's tokens and the eager waves' tokens equal;
     acceptance > 0 over the five paths (random weights: the greedy draft
     may never agree with the target, whose top-2 gaps are small; the
     sampled paths share the target's stream); layer 0's and layer 31's
     verify output within 2e-2 of 4 sequential decodes (bf16 and int8
     pools). Printed, not gated: the
     share of tokens equal to the plain graph path's, the plain model's
     top-2 logit gap at each request's first divergence, acceptance and
     tok/s (replayed and eager);
  7. xnor: the XNOR-popcount GEMM against its plain version, exactly, at
     the MNIST net's hidden layers (M = 1, 128, 256, 512; N = K = 1024),
     ragged K (40, 100, 384) and the spec draft's shapes (gate / up 8 x
     6912 x 2560, down 8 x 2560 x 6912); the
     yardstick is the same cuBLAS call as int8's, on unpacked signs; then
     the kernel at every K split it takes, each exact and repeatable,
     timed beside the split its host plan picks;
  8. hybrid_dense: the fused binary layer bit for bit against its plain
     version, twice, at the MNIST hidden layers (M = 256 first, then 1,
     128, 512; N = K = 1024), ragged M 77, ragged K 100 (N 64), K 384 (Kp
     12), a long K (8, 1024, 2560) that the plan splits, and scales and
     shifts that make y exactly +0.0 and -0.0; times beside the plain
     version, the bound, a flushed one-element fill_ and, as context, the
     unfused sequence it stands for (B1's kernel, then the f32 affine, the
     sign and pack_bits in torch: unfused_ms, its words equal to the
     kernel's); no single PyTorch call computes it, so no yardstick; then
     the kernel at every K split it takes, each exact and repeatable,
     timed beside the split its host plan picks;
  9. bf16_matmul: the bf16 GEMM within 2e-2 (tests/test_kernels.py), with
     hardtanh off and on, at (256, 1024, 512) and the MNIST float layers at
     batch 256 (fc0's K = 784, fc3's N = 10, fc1 / fc2's 1024 -> 1024);
     the yardstick is torch.mm; then each tile design (LARGE on wgmma,
     SMALL on mma.sync) at every K split, each within 2e-2 and the same bits
     on a second call, timed beside the plan's pick;
 10. mnist: the paper's net, the port's quickstart path: the hybrid net
     trains 2 epochs on SyntheticMnist, packs and runs packed inference,
     with the launch counts zeroed just before and read just after (B1
     exactly twice per forward); the float net trains too (no B1); both
     beat 0.6 test accuracy; packed logits through B1, through B2 and with
     latents are bitwise equal; packed inferences per second at batch 1
     and 256 (the paper's Table I protocol), warm, without an L2 flush;
 11. a JSON line of the nine kernels and the two kv_decode wrappers:
     launches summed over the paths (B2, B3, B4a-d and kv_decode on the
     serving paths, B1 on the spec and the MNIST paths, B5 and B6 on
     none; each serving and spec path's replayed counts held to its graph's
     kernel nodes, the bf16 and int8 paths' to the device's kernel events
     of the same run), largest
     error, times and bounds;

and last, ``{"ok": true, "device": {...}}``. Without a GPU it exits non-zero
and prints no result. Kernel times are CUDA-event medians of the device's
time for one call, with the 50 MB L2 flushed before each timed call (the
serving path meets its weights cold).
Every phase's lines also go to build/chip_smoke.json.
"""

from __future__ import annotations

import ctypes
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
from repro_torch.kernels import COUNTED, build  # noqa: E402
from repro_torch.kernels.bf16_matmul import bf16_matmul, bf16_matmul_plain  # noqa: E402
from repro_torch.kernels.binary_matmul import binary_matmul, binary_matmul_plain  # noqa: E402
from repro_torch.kernels.flash_attention import (flash_attention,  # noqa: E402
                                                 flash_attention_plain)
from repro_torch.kernels.hybrid_dense import hybrid_dense, hybrid_dense_plain  # noqa: E402
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_plain  # noqa: E402
from repro_torch.kernels.ksplit import splits_for  # noqa: E402
from repro_torch.kernels import kv_decode as kvd  # noqa: E402
from repro_torch.kernels import kv_quant as kvq  # noqa: E402
from repro_torch.models import get_model, lm_common as lc  # noqa: E402
from repro_torch.nn import attention as attn_lib  # noqa: E402
from repro_torch.nn.layers import embedding_lookup, rmsnorm_apply  # noqa: E402
from repro_torch.serving import kvcache as kvc  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

# name -> wrapper, every counted one; every launch count is zeroed before each path
KERNELS = {w.__name__: w for w in COUNTED}
SOURCES = ["int8_matmul", "flash_attention", "binary_matmul", "hybrid_dense",
           "bf16_matmul", "kv_quant", "kv_decode"]   # src/repro_torch/csrc/<name>.cu

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
    time, which exceeds a small kernel's own. A sample is kept only if the
    device was still held when the host had queued the end event (the start
    event not yet reached); otherwise the hold doubles and the sample is
    taken again, and a hold that never covers the call raises."""

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
        hold_ms = 2e3 * (time.perf_counter() - t0) + 0.05
        torch.cuda.synchronize()
        times = []
        while len(times) < reps:
            self.flush.zero_()
            torch.cuda._sleep(int(self.cycles_per_ms * hold_ms))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            covered = not start.query()
            end.synchronize()
            if covered:
                times.append(start.elapsed_time(end))
            elif hold_ms < 1e3:
                hold_ms *= 2
            else:
                raise RuntimeError("the device hold never covered the host's enqueue")
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
    ("decode M 1 bin_in", 1, 6912, 2560),
    ("decode M 1 bin_out", 1, 2560, 6912),
    ("decode M 16 bin_in", 16, 6912, 2560),
    ("decode M 16 bin_out", 16, 2560, 6912),
    ("spec verify bin_in M 32", 32, 6912, 2560),
    ("spec verify bin_out M 32", 32, 2560, 6912),
]
# activations drawn from all of [-128, 127]: the kernel is exact for any
# int8, and so are the plain f32 version and the yardsticks (|sum| < 2**24)
INT8_RANGE_CASES = [("decode bin_out, int8 range", 8, 2560, 6912),
                    ("prefill bin_in, int8 range", 1024, 6912, 2560)]


def phase_int8(dev, gen, timer) -> list[dict]:
    rows = []
    cases = [(c, False) for c in INT8_CASES] + [(c, True) for c in INT8_RANGE_CASES]
    for (name, m, n, k), full_range in cases:
        if full_range:
            a = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        else:
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


# the serving path's prefill and decode shapes, and the small prefill waves
SPLIT_CASES = INT8_CASES[:5] + [("prefill bin_in M 128", 128, 6912, 2560),
                                ("prefill bin_out M 256", 256, 2560, 6912)]


def _sweep(tag, name, dims, options, planned, same, timer, **extra) -> dict:
    """One kernel (B1, B2 or B6) at every launch its launcher takes:
    ``options`` maps a label (design / K chunks) to a call, each held by
    ``same`` to the plain result and required to give the same bits twice,
    and timed beside ``planned``, the label of the launch its host plan
    picks (the plan's model, measured)."""
    times = {}
    for label, call in options.items():
        got = call()
        same(got, f"{name}, {label}")
        if not torch.equal(got, call()):
            raise AssertionError(f"{tag}: a second call differs at {name}, {label}")
        times[label] = timer(call)
    best = min(times, key=times.get)
    row = dict(case=name, M=dims[0], N=dims[1], K=dims[2], **extra, ms_by_launch=times,
               planned=planned, best=best, planned_over_best=times[planned] / times[best])
    log(tag, **row)
    return row


def phase_int8_splits(dev, gen, timer) -> list[dict]:
    """B2 at each K split its kernel takes, each exact, beside the one
    plan() picks."""
    from repro_torch.kernels import int8_matmul as im
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, n, k in SPLIT_CASES:
        a = pack_signs_int8(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        want = int8_matmul_plain(a, pw)
        design, planned = im.plan(m, n, k, n_sms)
        kp = k // 32
        units = -(-kp // im.STAGE_WORDS)
        options = {f"{s} chunks": (lambda kc=im.STAGE_WORDS * -(-units // s):
                                   im._launch(a, pw, design, kc))
                   for s in splits_for(units)}

        def same(got, label):
            if not torch.equal(got, want):
                raise AssertionError(f"int8 kernel differs from plain at {label}")
        rows.append(_sweep("int8_split", name, (m, n, k), options, f"{-(-kp // planned)} chunks",
                           same, timer,
                           design="decode" if design == im.DECODE else "prefill"))
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
    ("S = T = 256, largest bucket", 8, 256, 256, 32, 32, 80, 0, None),
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
# phase 6: serve stablelm-3b at full width
# ---------------------------------------------------------------------------

N_REQUESTS, PROMPT_LENS, MAX_NEW = 12, (16, 48, 100, 128), 16
HEADER = 64           # tokens of the header the paged run's prompts share
# exact pool bytes of stablelm-3b at max_batch 8, max_len 256 (32 layers x
# 32 KV heads of 80: 327,680 / 167,936 / 28,672 bytes per token)
KV_BYTES = {"bf16": 671_088_640, "int8": 343_932_928, "binary": 58_720_256}
# the further serving paths: (label, ServeEngine options, header prompts).
# On the header prompts the first request runs alone, so the rest find its
# header on the radix tree; the contiguous int8 run on them is the paged
# run's like-for-like yardstick
KV_PATHS = [("int8", dict(kv_cache="int8"), False),
            ("binary", dict(kv_cache="binary"), False),
            ("int8, header prompts", dict(kv_cache="int8"), True),
            ("paged int8 + prefix cache", dict(kv_cache="int8", kv_block_size=16,
                                               prefix_cache=True), True)]


def _serve_once(api, params, prompts, staged=False, **kw):
    """Serve ``prompts`` through a fresh engine; ``staged``, the first
    request runs to its end before the others arrive."""
    eng = ServeEngine(api, params, max_batch=8, max_len=256, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new=MAX_NEW) for p in prompts[:1]]
    if staged:
        eng.run()
    rids += [eng.add_request(p, max_new=MAX_NEW) for p in prompts[1:]]
    res = eng.run()
    torch.cuda.synchronize()
    return [res[r] for r in rids], time.perf_counter() - t0, eng


OUR_KERNELS = {  # every __global__ function of src/repro_torch/csrc -> family
    "int8_matmul_mma_kernel": "int8_matmul (ours)",
    "int8_matmul_wgmma_kernel": "int8_matmul (ours)",
    "flash_fwd_mma_kernel": "flash_attention (ours)",
    "flash_fwd_simt_kernel": "flash_attention (ours)",
    "kv_encode_kernel": "kv_quant (ours)", "dequant_int8_kernel": "kv_quant (ours)",
    "dequant_binary_kernel": "kv_quant (ours)",
    "kv_decode_kernel": "kv_decode (ours)",
    "binary_matmul_mma_kernel": "binary_matmul (ours)",
    "hybrid_dense_mma_kernel": "hybrid_dense (ours)",
    "bf16_matmul_mma_kernel": "bf16_matmul (ours)",
    "bf16_matmul_wgmma_kernel": "bf16_matmul (ours)",
}


def _kernel_family(name: str) -> str:
    for sym, fam in OUR_KERNELS.items():
        if sym in name:
            return fam
    if any(t in name for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "float matmuls (cuBLAS)"
    return "other (elementwise, norms, copies, argmax)"


# wrapper -> the family its kernel functions' device events fall in (OUR_KERNELS)
WRAPPER_FAMILY = {name: ("kv_quant (ours)" if name.startswith(("kv_quant", "kv_dequant"))
                         else "kv_decode (ours)" if name.startswith("kv_decode")
                         else f"{name} (ours)") for name in KERNELS}


def _device_launches(prof) -> dict[str, int]:
    """Kernel events per family of ours in a profiled run: the device's own
    count of their launches, every node of every graph replay included."""
    from torch.autograd import DeviceType
    got = dict.fromkeys(sorted(set(OUR_KERNELS.values())), 0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and _kernel_family(evt.key) in got:
            got[_kernel_family(evt.key)] += evt.count
    return got


class _KernelNodeParams(ctypes.Structure):     # CUDA_KERNEL_NODE_PARAMS_v2, cuda.h
    _fields_ = [("func", ctypes.c_void_p)] + [
        (f, ctypes.c_uint) for f in ("grid_x", "grid_y", "grid_z", "block_x", "block_y",
                                     "block_z", "shared_mem")] + [
        ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
        ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def _graph_kernel_nodes(graph) -> dict[str, int]:
    """Kernel nodes per family of ours in a captured CUDA graph, named by
    libcuda (cuGraphGetNodes, cuGraphKernelNodeGetParams,
    cuFuncGetName / cuKernelGetName): the kernels one replay launches."""
    cu = ctypes.CDLL("libcuda.so.1")

    def ok(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")
    g, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    ok(cu.cuGraphGetNodes(g, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    ok(cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    got = dict.fromkeys(sorted(set(OUR_KERNELS.values())), 0)
    for node in nodes:
        node, kind = ctypes.c_void_p(node), ctypes.c_int()
        ok(cu.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value != 0:                                 # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        p, name = _KernelNodeParams(), ctypes.c_char_p()
        ok(cu.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)), "cuGraphKernelNodeGetParams")
        # a node libcuda cannot name counts as none of ours (a node of
        # ours left unnamed then shows as a missing node)
        if (p.func and cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(p.func)) == 0) or \
                (p.kern and cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(p.kern)) == 0):
            fam = _kernel_family(name.value.decode())
            if fam in got:
                got[fam] += 1
    return got


def _by_family(per_wrapper: dict[str, int]) -> dict[str, int]:
    out = dict.fromkeys(sorted(set(OUR_KERNELS.values())), 0)
    for name, n in per_wrapper.items():
        out[WRAPPER_FAMILY[name]] += n
    return out


def _counted_run(label, api, params, prompts, staged=False, profiled=False, **kw):
    """A path's counted run: the launch counts zeroed just before it and
    read just after. What a replay adds to them (serving/graphs.py, from
    the wrappers' counts during the capture) must equal, per family of
    ours, the kernel nodes of the graph that replayed. ``profiled``: the
    run is traced (torch.profiler), and per family the device's kernel
    events must equal the counts plus the graph's warm-up (one eager step,
    which the counts leave out as set-up).
    -> (tokens, wall s, engine, counts, profiler or None)"""
    from torch.profiler import ProfilerActivity, profile
    zero_counts()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out, wall, eng = _serve_once(api, params, prompts, staged=staged, **kw)
    else:
        prof = None
        out, wall, eng = _serve_once(api, params, prompts, staged=staged, **kw)
    launches = counts()
    nodes = _graph_kernel_nodes(eng.graph.graph)
    per_replay = _by_family(dict(zip(KERNELS, eng.graph.per_replay)))
    if nodes != per_replay:
        raise AssertionError(f"{label}: the graph's kernel nodes {nodes}, but a replay adds "
                             f"{per_replay}")
    if prof is None:
        return out, wall, eng, launches, None
    warm = dict(zip(KERNELS, eng.graph.warmup))
    want = _by_family({name: n + warm[name] for name, n in launches.items()})
    got = _device_launches(prof)
    if got != want:
        raise AssertionError(f"{label}: kernel events on the device {got}, want {want}: the "
                             f"wrappers counted {launches}, the warm-up {warm}")
    return out, wall, eng, launches, prof


def _profile(api, params, prompts, wall_unprofiled: float, **kw) -> dict:
    """The summary below of one profiled serving run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out, wall, _ = _serve_once(api, params, prompts, **kw)
    return {"out": out, **_profile_summary(prof, wall, wall_unprofiled)}


def _profile_summary(prof, wall: float, wall_unprofiled: float) -> dict:
    """Device time by kernel over one profiled serving run (kernel times
    come from the device's own clock), and the device's busy share of the
    same work run without the profiler, whose host-side recording stretches
    the profiled run's wall time."""
    from torch.autograd import DeviceType
    per_kernel = {}     # device-side events only: a CPU op's device time repeats its kernels'
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            per_kernel[evt.key] = (evt.self_device_time_total / 1e3, evt.count)
    fam: dict[str, float] = {}
    for name, (ms, _) in per_kernel.items():
        fam[_kernel_family(name)] = fam.get(_kernel_family(name), 0.0) + ms
    busy = sum(fam.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]
    return {"profiled_wall_ms": wall * 1e3, "device_busy_ms": busy,
            "busy_share": busy / (wall_unprofiled * 1e3),
            "device_ms_by_family": dict(sorted(fam.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": n[:90], "ms": ms, "count": c}
                            for n, (ms, c) in top]}


def _check_path(label, launches, eng, cfg, n_binary, kv: str, flash_waves: int) -> None:
    """Every kernel's launches on one serving path: B2 2 x binary blocks and
    the codec's insert kernel (K and V in one launch) once per layer per
    prefill wave and per decode step, the dequant-fused decode one per layer
    per decode step, the codec's dequantizer 2 x layers per wave on a cached
    prefix (the context's gather), B3 one per layer per wave without a
    cached prefix, all else 0;
    and the pool's exact bytes."""
    waves, steps = eng.stats["prefills"], eng.stats["decode_steps"]
    want = {k: 0 for k in KERNELS}
    want["int8_matmul"] = 2 * n_binary * (waves + steps)
    want["flash_attention"] = cfg.n_layers * flash_waves
    if kv != "bf16":
        want[f"kv_quant_{kv}"] = cfg.n_layers * (waves + steps)
        want[f"kv_decode_{kv}"] = cfg.n_layers * steps
        want[f"kv_dequant_{kv}"] = 2 * cfg.n_layers * (waves - flash_waves)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} for {waves} "
                             f"prefill waves + {steps} decode steps")
    per_tok = cfg.n_layers * kvc.get_codec(kv).bytes_per_token(cfg.n_kv_heads,
                                                               cfg.kv_head_dim())
    if not eng.stats["kv_bytes"] == KV_BYTES[kv] == per_tok * 8 * 256:
        raise AssertionError(f"{label}: kv_bytes {eng.stats['kv_bytes']}, want {KV_BYTES[kv]}")


def _check_outputs(label, out, vocab) -> None:
    for o in out:
        if len(o) != MAX_NEW or not all(0 <= t < vocab for t in o):
            raise AssertionError(f"{label}: bad output {o}")


def _fused_decode_layer0(params, cfg, toks, lens) -> dict:
    """Layer 0's K/V from a prefill, encoded by each quantized codec: the
    dequant-fused decode (the kv_decode kernel) against attention over the
    materialized cache (tests/test_kvcache.py's 2e-2)."""
    x = embedding_lookup(params["embed"], toks, compute_dtype=lc.cdt(cfg))
    h = rmsnorm_apply(params["blocks"][0]["ln1"], x)
    pos = torch.arange(toks.shape[1], device=toks.device)
    q, k, v = lc.gqa_qkv(params["blocks"][0]["attn"], h, cfg, pos)
    errs = {}
    for kv in ("int8", "binary"):
        codec = kvc.get_codec(kv)
        cache = codec.from_prefill(k, v, 64)
        cache["len"] = lens.clone()
        q1 = q[:, -1:].contiguous()
        got = codec.decode_attention(q1, cache)
        km, vm = codec.materialize(cache, head_dim=cfg.kv_head_dim())
        want = attn_lib.decode_attention(q1, km, vm, kv_len=cache["len"])
        errs[kv] = float((got.float() - want.float()).abs().max())
        if not errs[kv] <= 2e-2:
            raise AssertionError(f"layer 0 fused {kv} decode vs materialized: {errs[kv]}")
    return errs


def _eager_equal(label, out, api, params, prompts, staged=False, **kw):
    """The same requests served with every tick (or wave) run eagerly, not
    replayed from its CUDA graph: the tokens must be the replayed ones.
    -> the eager run's wall seconds."""
    e_out, e_wall, e_eng = _serve_once(api, params, prompts, staged=staged, cuda_graphs=False,
                                       **kw)
    if e_out != out:
        raise AssertionError(f"{label}: the graph replays gave other tokens than eager")
    if e_eng.graph is not None:
        raise AssertionError(f"{label}: cuda_graphs=False built a graph")
    return e_wall


def _check_replays(label, eng) -> None:
    """One graph replay per tick or wave, and no eager step on the card."""
    if eng.graph is None or eng.graph.replays != eng.stats["decode_steps"] or \
            eng.graph.eager_calls:
        raise AssertionError(f"{label}: {eng.graph and eng.graph.replays} replays for "
                             f"{eng.stats['decode_steps']} steps")


def _device_time(label, profiles, families) -> None:
    """Each family shows device time in the replayed profile and in the
    eager one."""
    for prof, how in zip(profiles, ("replayed", "eager")):
        for fam in families:
            if not prof["device_ms_by_family"].get(fam, 0.0) > 0.0:
                raise AssertionError(f"{label}: the {how} profile shows no device time for "
                                     f"{fam}: {prof['device_ms_by_family']}")


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
    header = rng.integers(0, cfg.vocab, HEADER)
    shared = [np.concatenate([header, p]) for p in prompts]

    # the main path, with the launch counts zeroed just before it and read
    # just after, under the profiler (its kernel events held to the
    # counts); each decode tick is one CUDA graph replay
    out, wall, eng, launches, prof_run = _counted_run("bf16", api, params, prompts,
                                                      profiled=True)
    waves, steps = eng.stats["prefills"], eng.stats["decode_steps"]
    _check_outputs("bf16", out, cfg.vocab)
    _check_path("bf16", launches, eng, cfg, n_binary, "bf16", waves)
    _check_replays("bf16", eng)
    out2, wall2, _ = _serve_once(api, params, prompts)
    if out2 != out:
        raise AssertionError("a second run of the same requests gave other tokens")
    wall_eager = _eager_equal("bf16", out, api, params, prompts)
    prof = _profile_summary(prof_run, wall, wall2)
    prof_eager = _profile(api, params, prompts, wall_eager, cuda_graphs=False)
    if prof_eager.pop("out") != out:
        raise AssertionError("the profiled eager run gave other tokens")
    _device_time("bf16", (prof, prof_eager), ("int8_matmul (ours)", "flash_attention (ours)"))

    # the further paths: each with its counts zeroed just before and read
    # just after, run twice for the same tokens, then eagerly
    paths, plain = [], {"bf16": out}
    for label, kw, on_header in KV_PATHS:
        batch = shared if on_header else prompts
        k_out, k_wall, k_eng, k_launches, k_prof = _counted_run(
            label, api, params, batch, staged=on_header, profiled=label == "int8", **kw)
        _check_outputs(label, k_out, cfg.vocab)
        # with the prefix cache only the first, lone wave prefills without
        # a cached prefix: every later request matches the header
        _check_path(label, k_launches, k_eng, cfg, n_binary, kw["kv_cache"],
                    1 if kw.get("prefix_cache") else k_eng.stats["prefills"])
        _check_replays(label, k_eng)
        if kw.get("prefix_cache") and not (k_eng.pool.stats["hits"] > 0 and
                                           k_eng.stats["cached_prompt_tokens"] > 0):
            raise AssertionError(f"{label}: no prefix hits {k_eng.pool.stats}")
        k_out2, k_wall2, _ = _serve_once(api, params, batch, staged=on_header, **kw)
        if k_out2 != k_out:
            raise AssertionError(f"{label}: a second run gave other tokens")
        k_wall_eager = _eager_equal(label, k_out, api, params, batch, staged=on_header, **kw)
        plain[label] = k_out
        n_tok = sum(len(o) for o in k_out)
        row = dict(path=label, tokens=n_tok, prefill_waves=k_eng.stats["prefills"],
                   decode_steps=k_eng.stats["decode_steps"], launches=k_launches,
                   graph_replays=k_eng.graph.replays,
                   kv_bytes=k_eng.stats["kv_bytes"],
                   kv_bytes_vs_bf16=KV_BYTES["bf16"] / k_eng.stats["kv_bytes"],
                   prefilled_tokens=k_eng.stats["prefilled_tokens"],
                   cached_prompt_tokens=k_eng.stats["cached_prompt_tokens"],
                   wall_s_first=k_wall, wall_s=k_wall2, wall_s_eager=k_wall_eager,
                   tok_per_s_first=n_tok / k_wall, tok_per_s=n_tok / k_wall2,
                   tok_per_s_eager=n_tok / k_wall_eager)
        if kw.get("prefix_cache"):
            row["prefix_pool"] = dict(k_eng.pool.stats)
        elif not on_header:
            row["tokens_as_bf16"] = sum(a == b for o, w in zip(k_out, out)
                                        for a, b in zip(o, w)) / n_tok
        if label == "int8":
            row["profile"] = _profile_summary(k_prof, k_wall, k_wall2)
            row["profile_eager"] = _profile(api, params, batch, k_wall_eager,
                                            cuda_graphs=False, **kw)
            if row["profile_eager"].pop("out") != k_out:
                raise AssertionError("the profiled eager int8 run gave other tokens")
            _device_time("int8", (row["profile"], row["profile_eager"]),
                         ("kv_decode (ours)", "kv_quant (ours)"))
        log("serve_kv", **row)
        paths.append(row)

    # logits finite and of the padded vocab; layer 0 (a float block) through
    # the flash kernel agrees with the plain attention on a small batch, and
    # its quantized caches decode as their materialized copies do
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
    fused_err = _fused_decode_layer0(params, cfg, toks, lens)
    n_tok = sum(len(o) for o in out)
    row = dict(card=card, arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
               binary_blocks=n_binary, requests=N_REQUESTS, tokens=n_tok,
               prefill_waves=waves, decode_steps=steps, launches=launches,
               graph_replays=eng.graph.replays, kv_bytes=eng.stats["kv_bytes"], init_s=init_s,
               wall_s_first=wall, wall_s=wall2, wall_s_eager=wall_eager,
               tok_per_s_first=n_tok / wall, tok_per_s=n_tok / wall2,
               tok_per_s_eager=n_tok / wall_eager,
               layer0_flash_vs_plain=layer0_err, layer0_fused_vs_materialized=fused_err,
               peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30)
    log("serve", **row)
    log("profile", card=card, **prof)
    log("profile_eager", card=card, **prof_eager)
    spec = phase_spec(api, params, cfg, prompts, shared, plain, n_binary, card)
    return {**row, "paths": paths, "spec": spec}


# ---------------------------------------------------------------------------
# phase 6b: speculative decoding at full width (the binarized self-draft)
# ---------------------------------------------------------------------------

SPEC_K = 3
# (label, ServeEngine options, header prompts, the plain path it is held to)
SPEC_PATHS = [("spec bf16", {}, False, "bf16"),
              ("spec int8", dict(kv_cache="int8"), False, "int8"),
              ("spec binary", dict(kv_cache="binary"), False, "binary"),
              ("spec paged int8 + prefix cache", dict(kv_cache="int8", kv_block_size=16,
                                                      prefix_cache=True), True,
               "paged int8 + prefix cache"),
              ("spec int8 sampled", dict(kv_cache="int8", temperature=0.8, seed=SEED), False,
               "int8 sampled")]


def _check_spec_path(label, launches, eng, cfg, n_binary, kv: str, flash_waves: int) -> None:
    """Every kernel's launches on a speculative path: per wave, k draft
    decodes and one verify of k + 1 tokens, so B1 3 x (float FFNs) x k (the
    draft's packed denses), B2 2 x (binary FFNs) x (k + 1), the codec's
    insert kernel and kv_decode layers x (k + 1) each (the verify's one span
    insert and one attend with q_lens); per prefill wave as on the plain
    paths; one draft launch and one graph replay a wave."""
    waves, w, k = eng.stats["prefills"], eng.stats["spec_waves"], eng.spec_k
    n_float = cfg.n_layers - n_binary
    want = {name: 0 for name in KERNELS}
    want["int8_matmul"] = 2 * n_binary * (waves + w * (k + 1))
    want["binary_matmul"] = 3 * n_float * k * w
    want["flash_attention"] = cfg.n_layers * flash_waves
    if kv != "bf16":
        want[f"kv_quant_{kv}"] = cfg.n_layers * (waves + w * (k + 1))
        want[f"kv_decode_{kv}"] = cfg.n_layers * w * (k + 1)
        want[f"kv_dequant_{kv}"] = 2 * cfg.n_layers * (waves - flash_waves)
    if launches != want:
        raise AssertionError(f"{label}: launches {launches}, want {want} for {waves} "
                             f"prefill waves + {w} spec waves")
    if not (eng.stats["spec_draft_launches"] == w == eng.stats["decode_steps"] > 0):
        raise AssertionError(f"{label}: draft launches {eng.stats['spec_draft_launches']}, "
                             f"{w} waves")
    _check_replays(label, eng)


def _top2_gaps(api, params, prompts, out, plain_out, dev) -> list:
    """At each request's first token that differs from the plain path's,
    the plain model's top-2 logit gap there (a prefill over the prompt and
    the plain tokens before it): how close to a tie the two paths split."""
    gaps = []
    for p, o, w in zip(prompts, out, plain_out):
        j = next((i for i, (a, b) in enumerate(zip(o, w)) if a != b), None)
        if j is None:
            continue
        seq = torch.as_tensor(np.concatenate([p, np.asarray(w[:j], np.int64)]), device=dev)
        logits, _ = api.prefill(params, {"tokens": seq[None]}, max_len=len(seq))
        top = torch.topk(logits[0].float(), 2).values
        gaps.append({"index": j, "gap": float(top[0] - top[1])})
    return gaps


def _verify_vs_decode(params, cfg, dev) -> dict:
    """Layer 0's and layer 31's verify pass (float FFNs, k + 1 = 4 tokens,
    the bf16 and the int8 pool) against 4 sequential decodes from the same
    prefilled cache: the span insert and the attend with q_lens against the
    decode insert and attend, within 2e-2 (absolute and relative, as the
    layer 0 flash check: the outputs are bf16, whose step at |x| >= 4
    exceeds 2e-2)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen, device=dev)
    new = torch.randint(0, cfg.vocab, (2, SPAN_S), generator=gen, device=dev)
    lens = torch.tensor([40, 17], dtype=torch.int32, device=dev)
    errs = {}
    for kv in ("bf16", "int8"):
        c = cfg.replace(kv_cache=kv)
        for layer in (0, cfg.n_layers - 1):
            p, sig = params["blocks"][layer], lc.block_sig(cfg, layer)
            x = embedding_lookup(params["embed"], toks, compute_dtype=lc.cdt(cfg))
            _, cache = lc.block_prefill(p, x, c, sig, positions=torch.arange(40, device=dev),
                                        max_len=64, seq_lens=lens)
            cache["len"].copy_(lens)
            seq = {n: a.clone() for n, a in cache.items()}
            xs = embedding_lookup(params["embed"], new, compute_dtype=lc.cdt(cfg))
            got, _ = lc.block_verify(p, xs, c, sig, cache)
            want = torch.cat([lc.block_decode(p, xs[:, j:j + 1], c, sig, seq)[0]
                              for j in range(SPAN_S)], dim=1)
            err = float((got.float() - want.float()).abs().max())
            errs[f"{kv} layer {layer}"] = err
            if not torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2) or \
                    not torch.equal(cache["len"], seq["len"]):
                raise AssertionError(f"verify vs sequential decode, {kv} layer {layer}: {err}")
    return errs


def phase_spec(api, params, cfg, prompts, shared, plain, n_binary, card) -> dict:
    """Full-width stablelm-3b with spec_k = 3 on five paths (bf16, int8,
    binary contiguous greedy; paged int8 with the prefix cache on the
    header prompts; int8 sampled at temperature 0.8), each wave one CUDA
    graph replay: every request gets its 16 tokens in range, the exact
    launches per wave, one draft launch a wave, a second run's tokens, the
    eager waves' tokens, acceptance > 0 over the five paths; printed beside
    them, not gated: the share of tokens equal to the plain graph path's,
    the plain logits' top-2 gap at each request's first divergence,
    acceptance and tok/s, and the draft's agreement with the target."""
    dev = params["embed"]["table"].device
    # the plain sampled int8 path the sampled spec path is held to
    s_out, _, s_eng, s_launches, _ = _counted_run("int8 sampled", api, params, prompts,
                                                  kv_cache="int8", temperature=0.8, seed=SEED)
    _check_outputs("int8 sampled", s_out, cfg.vocab)
    _check_path("int8 sampled", s_launches, s_eng, cfg, n_binary, "int8",
                s_eng.stats["prefills"])
    _check_replays("int8 sampled", s_eng)
    s_out2, s_wall2, _ = _serve_once(api, params, prompts, kv_cache="int8", temperature=0.8,
                                     seed=SEED)
    if s_out2 != s_out:
        raise AssertionError("int8 sampled: a second run gave other tokens")
    plain = {**plain, "int8 sampled": s_out}
    s_row = dict(path="int8 sampled", tokens=sum(len(o) for o in s_out),
                 decode_steps=s_eng.stats["decode_steps"], wall_s=s_wall2,
                 tok_per_s=sum(len(o) for o in s_out) / s_wall2, launches=s_launches)
    log("serve_kv", **s_row)
    rows = []
    for label, kw, on_header, base in SPEC_PATHS:
        batch = shared if on_header else prompts
        kw = dict(kw, spec_k=SPEC_K)
        out, wall, eng, launches, _ = _counted_run(label, api, params, batch,
                                                   staged=on_header, **kw)
        _check_outputs(label, out, cfg.vocab)
        _check_spec_path(label, launches, eng, cfg, n_binary, kw.get("kv_cache", "bf16"),
                         1 if kw.get("prefix_cache") else eng.stats["prefills"])
        out2, wall2, _ = _serve_once(api, params, batch, staged=on_header, **kw)
        if out2 != out:
            raise AssertionError(f"{label}: a second run gave other tokens")
        wall_eager = _eager_equal(label, out, api, params, batch, staged=on_header, **kw)
        n_tok = sum(len(o) for o in out)
        same = sum(a == b for o, w in zip(out, plain[base]) for a, b in zip(o, w)) / n_tok
        row = dict(path=label, plain_path=base, spec_k=SPEC_K, tokens=n_tok,
                   prefill_waves=eng.stats["prefills"], spec_waves=eng.stats["spec_waves"],
                   spec_drafted=eng.stats["spec_drafted"],
                   spec_accepted=eng.stats["spec_accepted"],
                   acceptance=eng.acceptance_rate(),
                   spec_draft_launches=eng.stats["spec_draft_launches"],
                   graph_replays=eng.graph.replays, launches=launches,
                   tokens_as_plain=same,
                   top2_gap_at_divergence=(None if kw.get("temperature") else
                                           _top2_gaps(api, params, batch, out, plain[base],
                                                      dev)),
                   wall_s_first=wall, wall_s=wall2, wall_s_eager=wall_eager,
                   tok_per_s=n_tok / wall2, tok_per_s_eager=n_tok / wall_eager,
                   cached_prompt_tokens=eng.stats["cached_prompt_tokens"])
        log("spec", **row)
        rows.append(row)
    # random weights: the greedy draft may never agree with the target (a
    # float FFN's draft output correlates ~0.17 with the target's, PERF.md),
    # the sampled one does, from the same stream; tests/test_torch_cuda.py
    # gates acceptance per path on a trained smoke LM
    if not sum(r["spec_accepted"] for r in rows) > 0:
        raise AssertionError(f"no draft token accepted on any spec path: {rows}")
    errs = _verify_vs_decode(params, cfg, dev)
    log("spec_verify", card=card, verify_vs_sequential_decode=errs)
    return {"paths": rows, "plain_sampled": s_row, "verify_vs_decode": errs}


# ---------------------------------------------------------------------------
# phase 5: KV quantize / dequantize (B4a-d)
# ---------------------------------------------------------------------------

KV_CASES = [  # (name, shape (..., D), dtype): the serving path's, then ragged
    ("decode insert (8, 1, 32, 80), bf16", (8, 1, 32, 80), torch.bfloat16),
    ("prefill encode (8, 128, 32, 80), bf16", (8, 128, 32, 80), torch.bfloat16),
    ("prefill encode (8, 128, 32, 80), f32", (8, 128, 32, 80), torch.float32),
    ("ragged rows (3, 7, 5, 80), bf16", (3, 7, 5, 80), torch.bfloat16),
    ("ragged rows, D 129, f32", (1, 37, 3, 129), torch.float32),
    ("D 16, bf16", (5, 9, 2, 16), torch.bfloat16),
]
F32_FLOPS = 67e12        # H100 SXM f32 outside the tensor cores (data sheet)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


INSERT_H, INSERT_D = 32, 80        # stablelm-3b's kv heads and head dim
PREFILL_S = 128                    # the serving path's prefill bucket, into max_len 256
FREE_SLOT = 4                      # DECODE_LENS' slot with len 0: all holes when paged
NO_YARDSTICK = "none: no single PyTorch call computes it"


def _random_leaves(kv, nb, t, dev, gen) -> dict:
    """A pool layer's leaves (nb, t, 32 heads, .) of random codes and
    scales, so rows the insert must not touch are told apart from zeros."""
    width = INSERT_D if kv == "int8" else packed_len(INSERT_D)
    lo, hi, dt = (-127, 128, torch.int8) if kv == "int8" else (-2 ** 31, 2 ** 31, torch.int32)

    def codes():
        return torch.randint(lo, hi, (nb, t, INSERT_H, width), generator=gen, device=dev,
                             dtype=dt)

    def scales():
        return torch.rand(nb, t, INSERT_H, generator=gen, device=dev).to(torch.bfloat16)
    return dict(zip(kvq.leaf_names(kv), (codes(), scales(), codes(), scales())))


def _insert_table(dev, gen, span: int = 1):
    """A paged layer's table for DECODE_LENS (block 16): each slot but the
    free one holds its pages up to the one its last token of ``span`` lands
    on, in shuffled blocks, holes past them; the slot at len 256 has every
    page, so its tokens land past the table. -> (table, n_blocks)."""
    n_pages = DECODE_T // PAGE
    used = [0 if i == FREE_SLOT else min((n + span - 1) // PAGE + 1, n_pages)
            for i, n in enumerate(DECODE_LENS)]
    n_blocks = sum(used) + 4
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    table = torch.full((DECODE_B, n_pages), n_blocks + 3, dtype=torch.int32)
    for i, u in enumerate(used):
        for p in range(u):
            table[i, p] = perm.pop()
    return table.to(dev), n_blocks


def _insert_before(kv, leaves, k, v, lens, table):
    """The decode insert as it ran before the insert kernel: two quantizer
    launches (the kernel's rows mode stands in for the retired row
    kernel), then the pool's torch scatter and the length bump."""
    quant = getattr(kvq, f"kv_quant_{kv}")
    (kc, ks), (vc, vs) = quant(k), quant(v)
    new = dict(zip(kvq.leaf_names(kv), (kc, ks, vc, vs)))
    if table is None:
        kvq.write_span(leaves, new, lens)
    else:
        kvq.write_paged(leaves, new, lens, table)
    return lens + 1


def _prefill_before(kv, k, v, max_len):
    """The prefill encode as it ran before: two quantizer launches, then
    each leaf zero-padded to max_len."""
    quant = getattr(kvq, f"kv_quant_{kv}")
    (kc, ks), (vc, vs) = quant(k), quant(v)
    return {n: kvq.pad_time(a, max_len) for n, a in zip(kvq.leaf_names(kv), (kc, ks, vc, vs))}


def _insert_bytes_ops(kv, n_rows, d, isz, out_rows) -> tuple[int, int]:
    """Bytes (n_rows of K and of V read, out_rows of codes and scales
    written) and f32 operations (int8 ~4 an element: |x|, max, divide,
    round; binary 2: |x|, add) of one insert."""
    width_b = d if kv == "int8" else 4 * packed_len(d)
    return (2 * n_rows * d * isz + 2 * out_rows * (width_b + 2),
            (4 if kv == "int8" else 2) * 2 * n_rows * d)


def phase_kv_insert(dev, gen, timer) -> dict[str, list]:
    """The insert kernel (B4a, B4c) at the serving shape against its plain
    version, bit for bit: the decode insert on the contiguous and the paged
    pool (the addressed blocks exact; the spare block takes the free slot's
    and the len-256 slot's rows in no set order), every other byte
    unchanged, a second call the same, the paged rows equal to the
    contiguous ones; the prefill encode into the padded cache. Times beside
    the plain version, the path it replaced (before_ms) and the bound."""
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    table, n_blocks = _insert_table(dev, gen)
    n_rows = DECODE_B * INSERT_H
    rows: dict[str, list] = {"kv_quant_int8": [], "kv_quant_binary": []}
    for kv in ("int8", "binary"):
        kname = f"kv_quant_{kv}"
        names = kvq.leaf_names(kv)
        k, v = (torch.randn(DECODE_B, 1, INSERT_H, INSERT_D, generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        k[1, 0, 3] = 0.0
        pools = {"contiguous": (_random_leaves(kv, DECODE_B, DECODE_T, dev, gen), None),
                 "paged": (_random_leaves(kv, n_blocks + 1, PAGE, dev, gen), table)}
        written = {}
        for pool, (start, tab) in pools.items():
            label = f"{kv}, {pool} decode insert"
            got, again, want = ({n: a.clone() for n, a in start.items()} for _ in range(3))
            got_lens = kvq.kv_insert(kv, got, k, v, lens, table=tab)
            kvq.kv_insert(kv, again, k, v, lens, table=tab)
            want_lens = kvq.kv_insert_plain(kv, want, k, v, lens, table=tab)
            torch.cuda.synchronize()
            cut = slice(None) if tab is None else slice(0, -1)     # the addressed blocks
            for n in names:
                if not (_same_bits(got[n][cut], want[n][cut]) and
                        _same_bits(again[n][cut], want[n][cut])):
                    raise AssertionError(f"kv_insert differs from plain at {label}, {n}")
            if not torch.equal(got_lens, want_lens):
                raise AssertionError(f"kv_insert's lengths differ at {label}")
            mask = torch.zeros(start[names[1]].shape[:2], dtype=torch.bool, device=dev)
            for i, n in enumerate(DECODE_LENS):
                if tab is None:
                    mask[i, min(n, DECODE_T - 1)] = True
                else:
                    page = n // PAGE
                    blk = int(tab[i, page]) if page < tab.shape[1] else n_blocks
                    mask[min(blk, n_blocks), n % PAGE] = True
            for n in names:
                if not _same_bits(got[n][~mask], start[n][~mask]):
                    raise AssertionError(f"kv_insert wrote outside its rows at {label}, {n}")
            written[pool] = got
            work, work_plain, work_before = ({n: a.clone() for n, a in start.items()}
                                             for _ in range(3))
            ms = timer(lambda: kvq.kv_insert(kv, work, k, v, lens, table=tab))
            plain_ms = timer(lambda: kvq.kv_insert_plain(kv, work_plain, k, v, lens,
                                                          table=tab), reps=10)
            before_ms = timer(lambda: _insert_before(kv, work_before, k, v, lens, tab),
                              reps=10)
            nbytes, ops = _insert_bytes_ops(kv, n_rows, INSERT_D, 2, n_rows)
            nbytes += 8 * DECODE_B + (4 * DECODE_B if tab is not None else 0)
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            row = dict(case=label, B=DECODE_B, T=DECODE_T, Hkv=INSERT_H, D=INSERT_D,
                       dtype="bfloat16", lens=DECODE_LENS, page=PAGE if tab is not None else None,
                       max_abs_err=0, ms=ms, plain_ms=plain_ms, before_ms=before_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=NO_YARDSTICK)
            log(kname, **row)
            rows[kname].append(row)
        for i, n in enumerate(DECODE_LENS):       # the paged pool got the contiguous rows
            page = n // PAGE
            blk = int(table[i, page]) if page < table.shape[1] else n_blocks
            if blk < n_blocks:
                for name in names:
                    if not _same_bits(written["paged"][name][blk, n % PAGE],
                                      written["contiguous"][name][i, n]):
                        raise AssertionError(f"kv_insert: paged differs from contiguous at "
                                             f"{kv}, slot {i}, {name}")
        rows[kname] += _span_insert(kv, lens, dev, gen, timer)
        for dt in (torch.bfloat16, torch.float32):
            label = f"{kv}, prefill encode ({DECODE_B}, {PREFILL_S} -> {DECODE_T}, " \
                    f"{INSERT_H}, {INSERT_D}), {str(dt).split('.')[-1]}"
            kp, vp = (torch.randn(DECODE_B, PREFILL_S, INSERT_H, INSERT_D, generator=gen,
                                  device=dev).to(dt) for _ in range(2))
            kp[2, 5, 7] = 0.0
            got = kvq.kv_prefill(kv, kp, vp, DECODE_T)
            again = kvq.kv_prefill(kv, kp, vp, DECODE_T)
            want = kvq.kv_prefill_plain(kv, kp, vp, DECODE_T)
            torch.cuda.synchronize()
            if not all(_same_bits(got[n], want[n]) and _same_bits(again[n], want[n])
                       for n in names):
                raise AssertionError(f"kv_prefill differs from plain at {label}")
            ms = timer(lambda: kvq.kv_prefill(kv, kp, vp, DECODE_T))
            plain_ms = timer(lambda: kvq.kv_prefill_plain(kv, kp, vp, DECODE_T), reps=10)
            before_ms = timer(lambda: _prefill_before(kv, kp, vp, DECODE_T), reps=10)
            nbytes, ops = _insert_bytes_ops(kv, DECODE_B * PREFILL_S * INSERT_H, INSERT_D,
                                            kp.element_size(), DECODE_B * DECODE_T * INSERT_H)
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            row = dict(case=label, B=DECODE_B, S=PREFILL_S, max_len=DECODE_T, Hkv=INSERT_H,
                       D=INSERT_D, dtype=str(dt).split(".")[-1], max_abs_err=0, ms=ms,
                       plain_ms=plain_ms, before_ms=before_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, library_call=NO_YARDSTICK)
            log(kname, **row)
            rows[kname].append(row)
    return rows


SPAN_S = 4            # the speculative verify's span at spec_k = 3


def _span_insert(kv, lens, dev, gen, timer) -> list[dict]:
    """The insert kernel's span mode (the verify's write of k + 1 = 4
    tokens a slot) at the serving shape against its plain version, bit for
    bit, on the contiguous pool (the start clamped to T - S) and a paged
    pool whose slots hold pages up to their span's last token (the slot at
    len 256 runs past the table, the free slot meets holes): every other
    byte unchanged, a second call the same, the paged rows the contiguous
    ones where both address a row; timed beside the plain version and the
    byte bound."""
    names = kvq.leaf_names(kv)
    table, n_blocks = _insert_table(dev, gen, span=SPAN_S)
    k, v = (torch.randn(DECODE_B, SPAN_S, INSERT_H, INSERT_D, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(2))
    pools = {"contiguous": (_random_leaves(kv, DECODE_B, DECODE_T, dev, gen), None),
             "paged": (_random_leaves(kv, n_blocks + 1, PAGE, dev, gen), table)}
    out, written = [], {}
    n_rows = DECODE_B * SPAN_S * INSERT_H
    for pool, (start, tab) in pools.items():
        label = f"{kv}, {pool} span insert (S {SPAN_S})"
        got, again, want = ({n: a.clone() for n, a in start.items()} for _ in range(3))
        got_lens = kvq.kv_insert(kv, got, k, v, lens, table=tab)
        kvq.kv_insert(kv, again, k, v, lens, table=tab)
        want_lens = kvq.kv_insert_plain(kv, want, k, v, lens, table=tab)
        torch.cuda.synchronize()
        cut = slice(None) if tab is None else slice(0, -1)
        for n in names:
            if not (_same_bits(got[n][cut], want[n][cut]) and
                    _same_bits(again[n][cut], want[n][cut])):
                raise AssertionError(f"kv_insert differs from plain at {label}, {n}")
        if not (torch.equal(got_lens, want_lens) and
                got_lens.tolist() == [n + SPAN_S for n in DECODE_LENS]):
            raise AssertionError(f"kv_insert's lengths differ at {label}")
        mask = torch.zeros(start[names[1]].shape[:2], dtype=torch.bool, device=dev)
        at = {}
        for i, n in enumerate(DECODE_LENS):
            for j in range(SPAN_S):
                if tab is None:
                    mask[i, min(n, DECODE_T - SPAN_S) + j] = True
                    at[i, n + j] = (i, min(n, DECODE_T - SPAN_S) + j)
                else:
                    p = n + j
                    blk = int(tab[i, p // PAGE]) if p // PAGE < tab.shape[1] else n_blocks
                    mask[min(blk, n_blocks), p % PAGE] = True
                    if blk < n_blocks:
                        at[i, p] = (blk, p % PAGE)
        for n in names:
            if not _same_bits(got[n][~mask], start[n][~mask]):
                raise AssertionError(f"kv_insert wrote outside its rows at {label}, {n}")
        written[pool] = (got, at)
        work, work_plain = ({n: a.clone() for n, a in start.items()} for _ in range(2))
        ms = timer(lambda: kvq.kv_insert(kv, work, k, v, lens, table=tab))
        plain_ms = timer(lambda: kvq.kv_insert_plain(kv, work_plain, k, v, lens, table=tab),
                         reps=10)
        nbytes, ops = _insert_bytes_ops(kv, n_rows, INSERT_D, 2, n_rows)
        nbytes += 8 * DECODE_B + (4 * DECODE_B * tab.shape[1] if tab is not None else 0)
        b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
        row = dict(case=label, B=DECODE_B, S=SPAN_S, T=DECODE_T, Hkv=INSERT_H, D=INSERT_D,
                   dtype="bfloat16", lens=DECODE_LENS, page=PAGE if tab is not None else None,
                   max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None, library_call=NO_YARDSTICK)
        log(f"kv_quant_{kv}", **row)
        out.append(row)
    (cg, cat_), (pg, pat) = written["contiguous"], written["paged"]
    for (i, p), (blk, off) in pat.items():       # the same rows on both pools
        if DECODE_LENS[i] + SPAN_S <= DECODE_T:          # not clamped on the contiguous pool
            ci, ct = cat_[i, p]
            for n in names:
                if not _same_bits(pg[n][blk, off], cg[n][ci, ct]):
                    raise AssertionError(f"span insert: paged differs from contiguous at "
                                         f"{kv}, slot {i}, position {p}, {n}")
    return out


def phase_kvquant(dev, gen, timer) -> dict[str, list]:
    """The insert kernel at the serving shape (phase_kv_insert), then B4a-d
    as row kernels bit for bit against their plain versions, each case with
    one all-zero row; times beside the bound (bytes: each input read once,
    each output written once, over 3.35 TB/s; the few f32 operations per
    element over 67 TFLOP/s bind less). No single PyTorch call computes any
    of the four, so there is no yardstick."""
    rows: dict[str, list] = {"kv_dequant_int8": [], "kv_dequant_binary": [],
                             **phase_kv_insert(dev, gen, timer)}
    for name, shape, dt in KV_CASES:
        d = shape[-1]
        x = torch.randn(*shape, generator=gen, device=dev).to(dt)
        x.view(-1, d)[1] = 0.0
        n, kp, isz = x.numel() // d, packed_len(d), x.element_size()
        q, s = kvq.kv_quant_int8(x)
        p, ps = kvq.kv_quant_binary(x)
        calls = {  # kernel -> (kernel call, plain call, bytes, f32 operations)
            "kv_quant_int8": (lambda: kvq.kv_quant_int8(x), lambda: kvq.kv_quant_int8_plain(x),
                              n * d * (isz + 1) + 2 * n, 4 * n * d),
            "kv_dequant_int8": (lambda: kvq.kv_dequant_int8(q, s, dtype=torch.float32),
                                lambda: kvq.kv_dequant_int8_plain(q, s, torch.float32),
                                n * d * 5 + 2 * n, n * d),
            "kv_quant_binary": (lambda: kvq.kv_quant_binary(x),
                                lambda: kvq.kv_quant_binary_plain(x),
                                n * d * isz + 4 * n * kp + 2 * n, 2 * n * d),
            "kv_dequant_binary": (lambda: kvq.kv_dequant_binary(p, ps, d, dtype=torch.float32),
                                  lambda: kvq.kv_dequant_binary_plain(p, ps, d, torch.float32),
                                  4 * n * kp + 2 * n + 4 * n * d, n * d),
        }
        for kname, (fn, plain, nbytes, ops) in calls.items():
            got, want = fn(), plain()
            torch.cuda.synchronize()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            if not all(_same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{kname} kernel differs from plain at {name}")
            ms = timer(fn)
            plain_ms = timer(plain, reps=10)
            b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
            row = dict(case=name if kname.startswith("kv_dequant") else f"rows mode, {name}",
                       rows=n, D=d, dtype=str(dt).split(".")[-1], max_abs_err=0,
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, library_call=NO_YARDSTICK)
            log(kname, **row)
            rows[kname].append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 5b: dequant-fused decode attention (B4b's and B4d's decode use)
# ---------------------------------------------------------------------------

DECODE_B, DECODE_T, PAGE = 8, 256, 16
DECODE_LENS = [144, 100, 17, 1, 0, 256, 48, 128]   # one free slot (0) and a full one
DECODE_CASES = [  # (name, Hq, Hkv, D, q dtype) at B 8, T 256, S 1
    ("serving (8, 1, 32, 80), bf16 q", 32, 32, 80, torch.bfloat16),
    ("serving, f32 q", 32, 32, 80, torch.float32),
    ("G 4 (Hq 32, Hkv 8), bf16 q", 32, 8, 80, torch.bfloat16),
    ("D 64, bf16 q", 32, 32, 64, torch.bfloat16),
    ("D 128, f32 q", 32, 32, 128, torch.float32),
]
# f32 q: the kernel and the plain version sum in other orders; bf16 q: the
# output's rounding, tests/test_kvcache.py's fused-decode tolerance
DECODE_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _decode_pools(kv, hkv, d, lens, dev, gen):
    """One layer's K/V encoded by the codec's quantizer on the contiguous
    pool (B, T, Hkv, .) and on a paged pool (block 16) holding the same
    values in shuffled blocks, with holes (past the pool) at and after each
    slot's ceil(len / 16)-th page. -> (contiguous leaves, paged leaves,
    table), leaves in the wrapper's order (k codes, k_s, v codes, v_s)."""
    quant = kvq.kv_quant_int8 if kv == "int8" else kvq.kv_quant_binary
    k = torch.randn(DECODE_B, DECODE_T, hkv, d, generator=gen, device=dev)
    v = torch.randn(DECODE_B, DECODE_T, hkv, d, generator=gen, device=dev)
    (kc, ks), (vc, vs) = quant(k.to(torch.bfloat16)), quant(v.to(torch.bfloat16))
    cont = [kc, ks, vc, vs]
    used = [-(-n // PAGE) for n in lens]
    n_blocks = sum(used) + 4
    perm = torch.randperm(n_blocks, generator=gen, device=dev).tolist()
    table = torch.full((DECODE_B, DECODE_T // PAGE), n_blocks + 3, dtype=torch.int32)
    paged = [x.new_zeros((n_blocks + 1, PAGE, *x.shape[2:])) for x in cont]
    for i, u in enumerate(used):
        for p in range(u):
            blk = perm.pop()
            table[i, p] = blk
            for dst, src in zip(paged, cont):
                dst[blk] = src[i, p * PAGE:(p + 1) * PAGE]
    return cont, paged, table.to(dev)


def _block_loop_decode(kv, q, leaves, lens, d, table):
    """The decode as it ran before the kv_decode kernel: the plain
    recurrence over kv blocks of 128 (all pages gathered first on the paged
    pool), each block dequantized by a B4b or B4d launch."""
    names = ("k_q", "k_s", "v_q", "v_s") if kv == "int8" else ("k_p", "k_s", "v_p", "v_s")

    def block(blk):
        if kv == "int8":
            return (kvq.kv_dequant_int8(blk["k_q"], blk["k_s"], dtype=torch.float32),
                    kvq.kv_dequant_int8(blk["v_q"], blk["v_s"], dtype=torch.float32))
        return (kvq.kv_dequant_binary(blk["k_p"], blk["k_s"], d, dtype=torch.float32),
                kvq.kv_dequant_binary(blk["v_p"], blk["v_s"], d, dtype=torch.float32))
    return kvd.fused_decode_plain(q, dict(zip(names, leaves)), lens, block, table=table)


def _decode_sdpa(hq, hkv, d, lens, dev, gen, timer) -> float | None:
    """Context, not a yardstick: one SDPA call over a bf16 cache of the same
    lengths (it reads 2x the int8 pool's bytes and dequantizes nothing)."""
    gqa = {} if hq == hkv else {"enable_gqa": True}
    if gqa and not SDPA_GQA:
        return None
    q = torch.randn(DECODE_B, hq, 1, d, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(DECODE_B, hkv, DECODE_T, d, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(DECODE_B, hkv, DECODE_T, d, generator=gen, device=dev).to(torch.bfloat16)
    cols = torch.arange(DECODE_T, device=dev)
    mask = (cols[None, :] < torch.tensor(lens, device=dev)[:, None])[:, None, None, :]
    return timer(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **gqa))


def phase_kv_decode(dev, gen, timer) -> dict[str, list]:
    """The kv_decode kernel (int8 and binary, contiguous and paged) against
    its plain version at the serving shape and at G 4, D 64 and 128, bf16
    and f32 q: rows with len >= 1 within DECODE_TOL, len-0 rows zeros, the
    same bits on a second call and on both pools; times beside the plain
    recurrence, the earlier loop of per-block B4b / B4d launches
    (before_ms) and the bound (the bytes below len, plus q and out, over
    3.35 TB/s; 4 D f32 flops a (query, key) pair bind less)."""
    lens_t = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    live = lens_t > 0
    rows: dict[str, list] = {"kv_decode_int8": [], "kv_decode_binary": []}
    for name, hq, hkv, d, qdt in DECODE_CASES:
        q = torch.randn(DECODE_B, 1, hq, d, generator=gen, device=dev).to(qdt)
        ctx_ms = _decode_sdpa(hq, hkv, d, DECODE_LENS, dev, gen, timer)
        for kv in ("int8", "binary"):
            wrapper = getattr(kvd, f"kv_decode_{kv}")
            plain = getattr(kvd, f"kv_decode_{kv}_plain")
            extra = () if kv == "int8" else (d,)
            cont, paged, table = _decode_pools(kv, hkv, d, DECODE_LENS, dev, gen)
            outs = {}
            for pool, leaves, tab in (("contiguous", cont, None), ("paged", paged, table)):
                call = lambda: wrapper(q, *leaves, lens_t, *extra, table=tab)   # noqa: E731
                got, again = call(), call()
                want = plain(q, *leaves, lens_t, *extra, table=tab)
                torch.cuda.synchronize()
                label = f"{kv}, {pool}, {name}"
                if not _same_bits(got, again):
                    raise AssertionError(f"kv_decode: a second call differs at {label}")
                err = float((got[live].float() - want[live].float()).abs().max())
                if not err <= DECODE_TOL[qdt]:
                    raise AssertionError(f"kv_decode vs plain at {label}: {err}")
                if bool(got[~live].any()):
                    raise AssertionError(f"kv_decode: a len-0 slot is not zeros at {label}")
                outs[pool] = got
                ms = timer(call)
                plain_ms = timer(lambda: plain(q, *leaves, lens_t, *extra, table=tab), reps=10)
                before_ms = timer(lambda: _block_loop_decode(kv, q, leaves, lens_t, d, tab),
                                  reps=10)
                row_b = d + 2 if kv == "int8" else 4 * packed_len(d) + 2
                visible = sum(min(n, DECODE_T) for n in DECODE_LENS)
                nbytes = (2 * visible * hkv * row_b + 2 * q.numel() * q.element_size()
                          + 4 * DECODE_B + (4 * sum(-(-n // PAGE) for n in DECODE_LENS)
                                            if tab is not None else 0))
                b_ms, b_by = bound(nbytes, 4.0 * hq * d * visible, F32_FLOPS)
                row = dict(case=f"{pool}, {name}", codec=kv, pool=pool, B=DECODE_B, T=DECODE_T,
                           Hq=hq, Hkv=hkv, D=d, q_dtype=str(qdt).split(".")[-1],
                           lens=DECODE_LENS, page=PAGE if tab is not None else None,
                           max_abs_err=err, tol=DECODE_TOL[qdt], ms=ms, plain_ms=plain_ms,
                           before_ms=before_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                           library_call="none: no single PyTorch call dequantizes and attends",
                           context_sdpa_bf16_ms=ctx_ms,
                           context_call="scaled_dot_product_attention(attn_mask=bool) over a "
                                        "bf16 cache of the same lengths: 2x the int8 bytes, "
                                        "not the same function")
                log("kv_decode", **row)
                rows[f"kv_decode_{kv}"].append(row)
            if not _same_bits(outs["contiguous"], outs["paged"]):
                raise AssertionError(f"kv_decode: paged differs from contiguous at {kv}, {name}")
    for kv in ("int8", "binary"):
        rows[f"kv_decode_{kv}"] += _decode_q_lens(kv, dev, gen, timer)
    return rows


def _decode_q_lens(kv, dev, gen, timer) -> list[dict]:
    """kv_decode with the verify's per-query lengths at the serving shape
    (B 8, S 4, 32 heads of 80, bf16 q; query j of slot b below min(lens[b]
    + j + 1, T), so the free slot's queries see its first positions) on the
    contiguous and the paged pool: within 2e-2 of the plain version, the
    same bits on a second call and on both pools, one launch (G S = 4 rows);
    timed beside the plain recurrence, the byte bound and, as context, SDPA
    over a bf16 cache with the same per-query masks."""
    hq = hkv = INSERT_H
    d = INSERT_D
    lens_t = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    q_lens = torch.clamp(lens_t[:, None] + torch.arange(1, SPAN_S + 1, device=dev)[None],
                         max=DECODE_T).to(torch.int32)
    q = torch.randn(DECODE_B, SPAN_S, hq, d, generator=gen, device=dev).to(torch.bfloat16)
    wrapper = getattr(kvd, f"kv_decode_{kv}")
    plain = getattr(kvd, f"kv_decode_{kv}_plain")
    extra = () if kv == "int8" else (d,)
    visible = [min(n + SPAN_S, DECODE_T) for n in DECODE_LENS]
    cont, paged, table = _decode_pools(kv, hkv, d, visible, dev, gen)
    sdpa_q = torch.randn(DECODE_B, hq, SPAN_S, d, generator=gen, device=dev).to(torch.bfloat16)
    sdpa_k, sdpa_v = (torch.randn(DECODE_B, hkv, DECODE_T, d, generator=gen, device=dev)
                      .to(torch.bfloat16) for _ in range(2))
    cols = torch.arange(DECODE_T, device=dev)
    mask = (cols[None, None, :] < q_lens[:, :, None])[:, None]        # (B, 1, S, T)
    ctx_ms = timer(lambda: F.scaled_dot_product_attention(sdpa_q, sdpa_k, sdpa_v,
                                                          attn_mask=mask))
    out, outs = [], {}
    for pool, leaves, tab in (("contiguous", cont, None), ("paged", paged, table)):
        label = f"{kv}, {pool}, verify (8, {SPAN_S}, 32, 80), bf16 q, q_lens"
        before = wrapper.launches
        call = lambda: wrapper(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens)  # noqa: E731
        got, again = call(), call()
        want = plain(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens)
        torch.cuda.synchronize()
        if wrapper.launches != before + 2:
            raise AssertionError(f"kv_decode with q_lens: {wrapper.launches - before} "
                                 f"launches for 2 calls at {label}")
        if not _same_bits(got, again):
            raise AssertionError(f"kv_decode: a second call differs at {label}")
        err = float((got.float() - want.float()).abs().max())
        if not err <= DECODE_TOL[torch.bfloat16]:
            raise AssertionError(f"kv_decode vs plain at {label}: {err}")
        outs[pool] = got
        ms = timer(call)
        plain_ms = timer(lambda: plain(q, *leaves, lens_t, *extra, table=tab, q_lens=q_lens),
                         reps=10)
        row_b = d + 2 if kv == "int8" else 4 * packed_len(d) + 2
        nbytes = (2 * sum(visible) * hkv * row_b + 2 * q.numel() * q.element_size()
                  + 4 * DECODE_B * (1 + SPAN_S)
                  + (4 * sum(-(-n // PAGE) for n in visible) if tab is not None else 0))
        flops = 4.0 * hq * d * int(q_lens.sum())
        b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
        row = dict(case=f"{pool}, verify S {SPAN_S} with q_lens, bf16 q", codec=kv, pool=pool,
                   B=DECODE_B, S=SPAN_S, T=DECODE_T, Hq=hq, Hkv=hkv, D=d, q_dtype="bfloat16",
                   lens=DECODE_LENS, page=PAGE if tab is not None else None,
                   max_abs_err=err, tol=DECODE_TOL[torch.bfloat16], ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None,
                   library_call="none: no single PyTorch call dequantizes and attends",
                   context_sdpa_bf16_ms=ctx_ms,
                   context_call="scaled_dot_product_attention(attn_mask=bool (B, 1, S, T)) "
                                "over a bf16 cache with the same per-query lengths")
        log("kv_decode", **row)
        out.append(row)
    if not _same_bits(outs["contiguous"], outs["paged"]):
        raise AssertionError(f"kv_decode with q_lens: paged differs from contiguous at {kv}")
    return out


# ---------------------------------------------------------------------------
# phase 7: XNOR-popcount GEMM
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
    ("spec draft w_down", 8, 2560, 6912),
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


def phase_xnor_splits(dev, gen, timer) -> list[dict]:
    """B1 at each K split it takes (1, 2, 4, 8 chunks of whole stages),
    each exact."""
    from repro_torch.kernels import binary_matmul as bm
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, n, k in XNOR_CASES:
        pa = pack_bits(torch.randn(m, k, generator=gen, device=dev))
        pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
        want = binary_matmul_plain(pa, pw, k)
        units = -(-packed_len(k) // bm.STAGE_WORDS)
        chunks = {s: bm.STAGE_WORDS * -(-units // s) for s in splits_for(units)}
        options = {f"{s} chunks": (lambda kc=kc: bm._launch(pa, pw, k, kc))
                   for s, kc in chunks.items()}
        planned = bm.plan(m, n, k, n_sms)

        def same(got, label):
            if not torch.equal(got, want):
                raise AssertionError(f"xnor kernel differs from plain at {label}")
        rows.append(_sweep("xnor_split", name, (m, n, k), options,
                           f"{-(-packed_len(k) // planned)} chunks", same, timer))
    return rows


# ---------------------------------------------------------------------------
# phase 8: fused hybrid dense
# ---------------------------------------------------------------------------

HYBRID_CASES = [  # (name, M, N, K, signed zero)
    ("mnist hidden, batch 256", 256, 1024, 1024, False),
    ("mnist hidden, batch 1", 1, 1024, 1024, False),
    ("mnist hidden, batch 128", 128, 1024, 1024, False),
    ("mnist hidden, batch 512", 512, 1024, 1024, False),
    ("ragged M 77", 77, 1024, 1024, False),
    ("ragged K 100", 32, 64, 100, False),
    ("K 384, Kp 12", 64, 1024, 384, False),
    ("long K 2560 (split)", 8, 1024, 2560, False),
    ("+-0.0 at the sign, batch 256", 256, 1024, 1024, True),
]


def _hybrid_inputs(m, n, k, signed_zero, dev, gen):
    """Packed signs and a scale / shift: random, or +-1 with shift -0.0
    (y = +0.0 / -0.0 where the dot is 0) and -+2 (y = +0.0 where it is 2),
    the second checked to put both zeros in y."""
    pa = pack_bits(torch.randn(m, k, generator=gen, device=dev))
    pw = pack_bits(torch.randn(n, k, generator=gen, device=dev))
    if not signed_zero:
        return (pa, pw, torch.randn(n, generator=gen, device=dev) * 0.1 + 0.5,
                torch.randn(n, generator=gen, device=dev) * 0.1)
    scale = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev).repeat(n // 4)
    shift = torch.tensor([-0.0, -0.0, -2.0, 2.0], device=dev).repeat(n // 4)
    y = binary_matmul_plain(pa, pw, k).float() * scale + shift
    if not (((y == 0) & torch.signbit(y)).any() and ((y == 0) & ~torch.signbit(y)).any()):
        raise AssertionError("the signed-zero case has no +0.0 or no -0.0 in y")
    return pa, pw, scale, shift


def _hybrid_unfused(pa, pw, scale, shift, k):
    """What B5 fuses, step by step: B1's kernel, then the f32 affine, the
    sign and pack_bits in torch."""
    return pack_bits(binary_matmul(pa, pw, k).float() * scale + shift)


def phase_hybrid(dev, gen, timer) -> list[dict]:
    """B5 bit for bit against its plain version at every case, twice; timed
    beside the plain version, the bound, a flushed one-element fill_ (the
    floor of one launch under this timer) and, as context, the unfused
    sequence it stands for (unfused_ms; its words must equal the
    kernel's)."""
    one = torch.zeros(1, device=dev)
    fill_ms = timer(lambda: one.fill_(1.0))
    rows = []
    for name, m, n, k, signed_zero in HYBRID_CASES:
        args = (*_hybrid_inputs(m, n, k, signed_zero, dev, gen), k)
        got, want = hybrid_dense(*args), hybrid_dense_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"hybrid_dense kernel differs from plain at {name}: "
                                 f"{int((got != want).sum())} words")
        if not torch.equal(hybrid_dense(*args), got):
            raise AssertionError(f"hybrid_dense: a second call differs at {name}")
        if not torch.equal(_hybrid_unfused(*args), got):
            raise AssertionError(f"hybrid_dense: the unfused sequence differs at {name}")
        ms = timer(lambda: hybrid_dense(*args))
        plain_ms = timer(lambda: hybrid_dense_plain(*args), reps=10)
        unfused_ms = timer(lambda: _hybrid_unfused(*args))
        kp = packed_len(k)
        b_ms, b_by = bound(4 * (m * kp + n * kp + 2 * n + m * n / 32), 2.0 * m * n * k,
                           INT8_OPS)
        row = dict(case=name, M=m, N=n, K=k, max_abs_err=0, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, library_ms=None, library_call=NO_YARDSTICK,
                   unfused_ms=unfused_ms, fill_ms=fill_ms, over_fill=ms / fill_ms)
        log("hybrid_dense", **row)
        rows.append(row)
    return rows


def phase_hybrid_splits(dev, gen, timer) -> list[dict]:
    """B5 at each K split it takes (1, 2, 4, 8 chunks of whole stages),
    each bit-exact and repeatable, timed beside the plan's pick."""
    from repro_torch.kernels import hybrid_dense as hd
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for name, m, n, k, signed_zero in HYBRID_CASES:
        args = (*_hybrid_inputs(m, n, k, signed_zero, dev, gen), k)
        want = hybrid_dense_plain(*args)
        units = -(-packed_len(k) // hd.STAGE_WORDS)
        chunks = {s: hd.STAGE_WORDS * -(-units // s) for s in splits_for(units)}
        options = {f"{s} chunks": (lambda kc=kc: hd._launch(*args, kc))
                   for s, kc in chunks.items()}
        planned = hd.plan(m, n, k, n_sms)

        def same(got, label):
            if not torch.equal(got, want):
                raise AssertionError(f"hybrid_dense kernel differs from plain at {label}")
        rows.append(_sweep("hybrid_split", name, (m, n, k), options,
                           f"{-(-packed_len(k) // planned)} chunks", same, timer))
    return rows


# ---------------------------------------------------------------------------
# phase 9: bf16 GEMM
# ---------------------------------------------------------------------------

BF16_CASES = [  # (name, M, N, K, hardtanh)
    ("mnist fc0, batch 256", 256, 1024, 784, False),
    ("mnist fc0, batch 256, hardtanh", 256, 1024, 784, True),
    ("mnist fc3, batch 256", 256, 10, 1024, False),
    ("mnist fc3, batch 256, hardtanh", 256, 10, 1024, True),
    ("256 x 1024 x 512", 256, 512, 1024, False),
    ("256 x 1024 x 512, hardtanh", 256, 512, 1024, True),
    ("mnist fc1 / fc2, batch 256", 256, 1024, 1024, False),
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


def phase_bf16_splits(dev, gen, timer) -> list[dict]:
    """B6 at each tile design (LARGE, SMALL) and K split it takes, each
    within GEMM_TOL of the plain version."""
    from repro_torch.kernels import bf16_matmul as bfm
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    names = {bfm.LARGE: "large", bfm.SMALL: "small"}
    rows = []
    for name, m, n, k, ht in BF16_CASES:
        a = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device=dev) / k ** 0.5).to(torch.bfloat16)
        want = bf16_matmul_plain(a, w, hardtanh=ht)
        units = -(-k // bfm.STAGE_K)
        options = {f"{names[d]}/{s}": (lambda d=d, kc=bfm.STAGE_K * -(-units // s):
                                       bfm._launch(a, w, ht, d, kc))
                   for d in bfm.TILES for s in splits_for(units)}
        design, kchunk = bfm.plan(m, n, k, n_sms)

        def same(got, label):
            if not torch.allclose(got, want, rtol=GEMM_TOL, atol=GEMM_TOL):
                raise AssertionError(f"bf16 kernel vs plain at {label}: "
                                     f"{float((got - want).abs().max())}")
        rows.append(_sweep("bf16_split", name, (m, n, k), options,
                           f"{names[design]}/{-(-k // kchunk)}", same, timer))
    return rows


# ---------------------------------------------------------------------------
# phase 10: the paper's MNIST net (the port's quickstart path)
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


# ---------------------------------------------------------------------------
# phase 2b: what ptxas and the SASS say about each kernel function
# ---------------------------------------------------------------------------

def _demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return names
    return out if len(out) == len(names) else names


def phase_build_report() -> list[dict]:
    """Per kernel function of each library: registers, stack and spill
    bytes from ptxas (-Xptxas=-v output kept in build/kernels/<name>.log),
    and its tensor-core instructions (SASS opcodes ending in MMA: IMMA,
    HMMA, and IGMMA / HGMMA for wgmma) counted by opcode in cuobjdump -sass
    (None where the toolkit has no cuobjdump)."""
    import re
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    rows = []
    for src in SOURCES:
        log_text = (build.BUILD_DIR / f"{src}.log").read_text()
        funcs: dict[str, dict] = {}
        cur = None
        for line in log_text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                cur = funcs.setdefault(m.group(1), {})
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and cur is not None:
                cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
        sass: dict[str, dict] | None = None
        if cuobjdump.exists():
            text = subprocess.run([str(cuobjdump), "-sass", str(build.library_path(src))],
                                  capture_output=True, text=True, check=True).stdout
            sass, fn = {}, None
            for line in text.splitlines():
                m = re.search(r"Function : (\w+)", line)
                if m:
                    fn = sass.setdefault(m.group(1), {})
                    continue
                # an instruction line: /*addr*/ [@predicate] OPCODE.modifiers ...
                m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
                if m and m.group(1).endswith("MMA") and fn is not None:
                    fn[m.group(1)] = fn.get(m.group(1), 0) + 1
        for mangled, name in zip(funcs, _demangle(list(funcs))):
            if name.endswith(")"):          # drop the parameter list
                name = name[:name.rfind("(")]
            name = name.replace("(anonymous namespace)::", "")
            row = dict(source=f"src/repro_torch/csrc/{src}.cu", function=name,
                       **funcs[mangled],
                       tensor_core_ops=None if sass is None else sass.get(mangled, {}))
            log("kernel_build", **row)
            rows.append(row)
    return rows


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
    build.build_all(SOURCES)
    log("build", seconds=time.perf_counter() - t0, dir=str(build.BUILD_DIR))
    # B2's two designs, B3's bf16 instantiations, B1 and B5 (b1 BMMA) and
    # B6's two designs (HGMMA, HMMA) run on the tensor cores: each
    # function's SASS must hold its opcode
    build_rows = phase_build_report()
    for sym, kind in (("int8_matmul_mma_kernel", "IMMA"), ("int8_matmul_wgmma_kernel", "IGMMA"),
                      ("flash_fwd_mma_kernel", "HMMA"), ("binary_matmul_mma_kernel", "BMMA"),
                      ("hybrid_dense_mma_kernel", "BMMA"),
                      ("bf16_matmul_wgmma_kernel", "HGMMA"), ("bf16_matmul_mma_kernel", "HMMA")):
        counted = [r["tensor_core_ops"] for r in build_rows if sym in r["function"]]
        if not counted:
            raise AssertionError(f"no {sym} in the build logs")
        if any(c is not None and kind not in c for c in counted):
            raise AssertionError(f"{sym}: no {kind} instruction in its SASS: {counted}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    timer = Timer(dev)
    int8_rows = phase_int8(dev, gen, timer)
    phase_int8_splits(dev, gen, timer)
    flash_rows = phase_flash(dev, gen, timer)
    kv_rows = phase_kvquant(dev, gen, timer)
    decode_rows = phase_kv_decode(dev, gen, timer)
    serve = phase_serve(dev, smi)
    xnor_rows = phase_xnor(dev, gen, timer)
    phase_xnor_splits(dev, gen, timer)
    hybrid_rows = phase_hybrid(dev, gen, timer)
    phase_hybrid_splits(dev, gen, timer)
    bf16_rows = phase_bf16(dev, gen, timer)
    phase_bf16_splits(dev, gen, timer)
    del timer
    mnist = phase_mnist(dev, smi)

    # launches on every path: the serving paths (bf16, int8, binary, paged
    # int8 with the prefix cache, int8 sampled), the speculative paths and
    # the MNIST net, each counted from 0
    path_launches = [serve["launches"], mnist["launches"],
                     *(p["launches"] for p in serve["paths"]),
                     serve["spec"]["plain_sampled"]["launches"],
                     *(p["launches"] for p in serve["spec"]["paths"])]

    def entry(kname, source, replaces, rows):
        # the headline case is the first: decode bin_in, full-length flash,
        # the decode insert, the MNIST hidden layer at the training batch,
        # at batch 256, fc0
        head = rows[0]
        return {"name": kname, "route": "cuda", "source": source, "replaces": replaces,
                "launches": sum(pl[kname] for pl in path_launches),
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
        *(entry(k, "src/repro_torch/csrc/kv_quant.cu", f"src/repro/kernels/kv_quant.py:{line}",
                kv_rows[k])
          for k, line in (("kv_quant_int8", 161), ("kv_dequant_int8", 179),
                          ("kv_quant_binary", 195), ("kv_dequant_binary", 211))),
        *(entry(k, "src/repro_torch/csrc/kv_decode.cu",
                f"src/repro/kernels/kv_quant.py:{line} (decode use, "
                "src/repro/serving/kvcache.py:282, :696)", decode_rows[k])
          for k, line in (("kv_decode_int8", 179), ("kv_decode_binary", 211))),
    ]}
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps({**RECORD, **kernels}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
