"""Serving launcher: random-init a registered LM on the card and run a batch
of requests through the continuous-batching slot engine (or the bucket
baseline), or serve it over HTTP.

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
``--engine bucket`` runs the run-to-completion baseline
(serving/bucket.py) instead of the slot engine.

Prefill and scheduling: ``--prefill-chunk C`` prefills in C-token chunks
through the verify path; ``--interleave`` runs one prefill slice a tick
beside the decode batch instead of blocking waves (on by default under
``--http``); ``--scheduler slo`` admits by SLO class with a starvation
bound.

Telemetry (serving/telemetry.py; slot engine only; host-side, no device
work): ``--metrics-out m.json`` writes the metrics registry (``.prom``:
Prometheus text), ``--trace-out t.json`` the request-lifecycle spans as
Chrome trace-event JSON (open it in https://ui.perfetto.dev),
``--stats-every N`` logs a one-line summary every N ticks, and
``--torch-profile DIR`` also records a torch.profiler trace of the run into
DIR (it warns once and serving goes on where the profiler cannot start).
The files are written in a ``finally``: an interrupted run still leaves
them behind, and Ctrl-C exits 0.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 8 --interleave --trace-out /tmp/serve_trace.json \\
      --metrics-out /tmp/serve_metrics.json --stats-every 8

``--http PORT`` serves over HTTP/SSE (launch/server.py) until Ctrl-C: POST
/v1/generate, GET /healthz, GET /metrics.
"""

from __future__ import annotations

import argparse
import json
import logging
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.kernels.ops import SPEC_DRAFT_IMPLS
from repro_torch.models import get_model
from repro_torch.nn.attention import ATTN_IMPLS
from repro_torch.serving.bucket import BucketEngine
from repro_torch.serving.engine import ServeEngine

log = logging.getLogger("repro_torch.serve")


def _flush_telemetry(args, telemetry) -> None:
    """Write --metrics-out / --trace-out. Called from a finally, so an
    interrupted or failed run still leaves parseable files behind."""
    if telemetry is None:
        return
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            if args.metrics_out.endswith(".prom"):
                f.write(telemetry.metrics_prometheus())
            else:
                f.write(telemetry.metrics_json(indent=2) + "\n")
        log.info("wrote metrics to %s", args.metrics_out)
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(telemetry.chrome_trace(), f)
        log.info("wrote Perfetto-loadable trace to %s", args.trace_out)


def _serve_http(args, eng, telemetry) -> dict:
    """--http mode: hand the engine to the SSE front door and block until
    Ctrl-C, or raise once an engine tick has failed; telemetry is flushed
    on the way out, as in the batch drive."""
    from repro_torch.launch.server import FrontDoor
    fd = FrontDoor(eng, host=args.http_host, port=args.http, queue_limit=args.queue_limit)
    fd.start()
    log.info("serving on http://%s:%d (POST /v1/generate, GET /healthz, GET /metrics); "
             "Ctrl-C to stop", fd.host, fd.port)
    try:
        while True:
            time.sleep(1.0)
            if fd.failure is not None:
                raise RuntimeError(f"engine failed: {fd.failure['error']['message']}")
            if args.stats_every and telemetry is not None:
                log.info("%s", telemetry.summary_line())
    except KeyboardInterrupt:
        log.info("shutting down")
    finally:
        fd.close()
        _flush_telemetry(args, telemetry)
    return dict(eng.results)


def _drive(args, eng, telemetry) -> None:
    """Run the queued requests to their end (with a summary line every
    --stats-every ticks)."""
    if args.stats_every and telemetry is not None:
        ticks = 0
        while eng.step():
            ticks += 1
            if ticks % args.stats_every == 0:
                log.info("tick %d: %s", ticks, telemetry.summary_line())
    else:
        eng.run()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, default="stablelm-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="",
                    help="load params from a checkpoint (not ported: ROADMAP A7)")
    ap.add_argument("--engine", choices=["slot", "bucket"], default="slot")
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
    ap.add_argument("--attn-impl", default=None, choices=list(ATTN_IMPLS),
                    help="attention backend override (see nn/attention.py)")
    ap.add_argument("--stop-tokens", default="",
                    help="comma-separated token ids that end generation early "
                         "(EOS-style; slot engine only)")
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
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="tensor-parallel serving over N devices (not ported: ROADMAP A9)")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                    help="blockwise prefill: C-token chunks through the verify path "
                         "(0 = monolithic; a power of two; slot engine)")
    ap.add_argument("--interleave", default=None, action=argparse.BooleanOptionalAction,
                    help="interleaved prefill: one prefill slice per tick beside the "
                         "decode batch instead of blocking waves (slot engine; default "
                         "on under --http)")
    ap.add_argument("--scheduler", default="fifo", choices=["fifo", "slo"],
                    help="admission policy: fifo, or slo (SLO classes interactive > "
                         "standard > batch, with a hard starvation bound)")
    ap.add_argument("--metrics-out", default="", metavar="PATH",
                    help="write the telemetry metrics here at exit: JSON, or Prometheus "
                         "text when PATH ends in .prom (slot engine only)")
    ap.add_argument("--trace-out", default="", metavar="PATH",
                    help="write the request-lifecycle spans here as Chrome trace-event "
                         "JSON (load in Perfetto; slot engine only)")
    ap.add_argument("--torch-profile", default="", metavar="DIR",
                    help="also record a torch.profiler trace into DIR; warns once and "
                         "keeps serving if the profiler cannot start")
    ap.add_argument("--stats-every", type=int, default=0, metavar="N",
                    help="log a one-line telemetry summary every N ticks (0 = off; slot "
                         "engine only)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve over HTTP/SSE instead of a synthetic batch: POST "
                         "/v1/generate, GET /healthz, GET /metrics, until Ctrl-C; port 0 "
                         "picks a free port (logged at start-up)")
    ap.add_argument("--http-host", default="127.0.0.1", help="bind address for --http")
    ap.add_argument("--queue-limit", type=int, default=64,
                    help="bounded HTTP admission queue: beyond this many waiting "
                         "submissions, POSTs answer 429 + Retry-After")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir: checkpoints are not ported yet (ROADMAP A7)")
    if args.mesh:
        raise NotImplementedError("--mesh: tensor-parallel serving is not ported yet "
                                  "(ROADMAP A9)")

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    api = get_model(cfg)
    params = api.init(args.init_seed, device=args.device)
    plens = [int(x) for x in args.prompt_lens.split(",")]
    max_len = max(plens) + args.max_new + 8 + args.spec_decode
    stop = frozenset(int(x) for x in args.stop_tokens.split(",") if x)
    http = args.http is not None        # --http 0 serves on a free port
    spec_k = args.spec_decode
    telemetry = None
    if args.metrics_out or args.trace_out or args.stats_every or args.torch_profile \
            or http:
        from repro_torch.serving.telemetry import Telemetry
        telemetry = Telemetry()
    # interleaved prefill defaults on behind the HTTP front door, as in the
    # reference, and off for the batch drive. On the card it does not yet
    # protect the ITL it is meant to: a slice runs eagerly and costs about
    # the host time of a whole blocking wave, so TTFT and ITL are both worse
    # than with --no-interleave (ROADMAP C, the interleave default; A5 (a))
    interleave = http if args.interleave is None else args.interleave
    if http and args.interleave is None and torch.device(args.device).type == "cuda":
        log.warning("--http turns --interleave on; on the card eager prefill slices "
                    "currently give a longer TTFT and ITL than --no-interleave "
                    "(ROADMAP C)")
    if args.engine == "slot":
        eng = ServeEngine(api, params, max_batch=args.max_batch, max_len=max_len,
                          temperature=args.temperature, seed=args.seed,
                          attn_impl=args.attn_impl, kv_cache=args.kv_cache,
                          kv_block_size=args.kv_block_size, prefix_cache=args.prefix_cache,
                          spec_k=spec_k, spec_draft_impl=args.spec_draft_impl,
                          prefill_chunk=args.prefill_chunk, telemetry=telemetry,
                          interleave=interleave, scheduler=args.scheduler)
    else:
        if args.kv_block_size or args.prefix_cache or stop or spec_k \
                or args.prefill_chunk or http or interleave \
                or args.scheduler != "fifo":
            ap.error("--kv-block-size/--prefix-cache/--stop-tokens/--spec-decode/"
                     "--prefill-chunk/--http/--interleave/--scheduler slo need the slot "
                     "engine")
        if telemetry is not None:
            ap.error("--metrics-out/--trace-out/--torch-profile/--stats-every need the "
                     "slot engine")
        eng = BucketEngine(api, params, max_batch=args.max_batch, max_len=max_len,
                           temperature=args.temperature, seed=args.seed,
                           attn_impl=args.attn_impl, kv_cache=args.kv_cache)
    if http:
        return _serve_http(args, eng, telemetry)
    rng = np.random.default_rng(args.init_seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, int(rng.choice(plens)))
        if isinstance(eng, ServeEngine):
            eng.add_request(prompt, max_new=args.max_new, stop_tokens=stop)
        else:
            eng.add_request(prompt, max_new=args.max_new)
    profiler = False
    if args.torch_profile:
        from repro_torch.serving.telemetry import start_torch_profiler
        profiler = start_torch_profiler(args.torch_profile)
    t0 = time.perf_counter()
    # the flush lives in a finally: a Ctrl-C (or a failing tick) still
    # leaves parseable --metrics-out / --trace-out files behind
    try:
        _drive(args, eng, telemetry)
    except KeyboardInterrupt:
        log.warning("interrupted; flushing telemetry for the partial run")
    finally:
        results = dict(eng.results)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        dt = time.perf_counter() - t0
        if profiler:
            from repro_torch.serving.telemetry import stop_torch_profiler
            log.info("wrote the torch.profiler trace to %s", stop_torch_profiler(profiler))
        _flush_telemetry(args, telemetry)
    toks = sum(len(v) for v in results.values())
    log.info("served %d requests, %d tokens in %.3fs (%.1f tok/s) on %s",
             len(results), toks, dt, toks / max(dt, 1e-9),
             torch.cuda.get_device_name(eng.device) if eng.device.type == "cuda"
             else "cpu")
    if isinstance(eng, ServeEngine):
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
