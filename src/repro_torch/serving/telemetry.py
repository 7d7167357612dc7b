"""Serving telemetry: metrics registry + request-lifecycle tracer (a copy
of repro/serving/telemetry.py, so that this package imports nothing from
repro; the device-trace hook runs torch.profiler).

Two host-side pieces, usable separately but normally bundled behind one
``Telemetry`` facade that ``ServeEngine(telemetry=...)`` threads through
every tick:

  MetricsRegistry   counters, gauges, and log-bucketed histograms (TTFT,
                    ITL, queue wait, per-phase tick durations, cache
                    pressure) with JSON and Prometheus text exposition.
  Tracer            per-request lifecycle spans — queued -> prefill ->
                    first token -> decode ticks / spec waves ->
                    finished|evicted — plus an engine lane of per-tick
                    phase spans, exported as Chrome trace-event JSON
                    (load the file in Perfetto / chrome://tracing).

The overhead contract — **zero extra device work**
--------------------------------------------------
Telemetry must never change what the engine launches. Everything in this
module reads host clocks (``time.perf_counter``) and host integers the
engine already holds; nothing here imports torch at module scope, touches
a tensor, or synchronizes the device. Tick durations are honest anyway:
the engine already synchronizes on every tick when it reads the picked
tokens to the host, so the host wall-time between tick start and token
consumption covers launch + device compute (a graph replay on a card)
without telemetry adding a sync of its own. A prefill slice runs between
two such reads, so its span times the host's enqueue of the slice, as
repro's does. ``tests/test_torch_telemetry.py`` pins the contract:
telemetry on vs. off gives the same tokens and the same calls into the
model, and, on a card, the same kernel launches and graph replays.

The opt-in exception is :func:`start_torch_profiler` — an explicit request
for a *device* trace (``torch.profiler``), which is torch's machinery, not
this module's bookkeeping, and degrades to a one-time warning where the
profiler cannot start.
"""

from __future__ import annotations

import json
import threading
import time
import warnings


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def inc(self, n: float = 1.0):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease by {n}")
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float):
        self.value = float(v)


def log_buckets(lo: float, hi: float, growth: float = 2.0) -> tuple:
    """Exponential bucket upper bounds: lo, lo*growth, ... >= hi."""
    if lo <= 0 or growth <= 1:
        raise ValueError(f"need lo > 0 and growth > 1, got {lo}, {growth}")
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= growth
    out.append(b)
    return tuple(out)


# durations: 1 us .. ~137 s, factor 2 (28 buckets) — wide enough for a
# single CPU prefill wave and fine enough to separate draft from verify
TIME_BUCKETS = log_buckets(1e-6, 128.0)


class Histogram:
    """Log-bucketed histogram that also keeps the raw observations.

    The buckets are the Prometheus-style cumulative exposition (bounded,
    mergeable across scrapes); the raw sample list is what lets
    ``percentile`` answer exactly instead of to within a bucket width —
    benchmark runs observe a few thousand values at most, so keeping them
    is cheap, and `serve_bench`'s p50/p99 rows stay bit-comparable with
    the hand-rolled ``np.percentile`` capture they replaced.
    """

    __slots__ = ("name", "help", "buckets", "counts", "count", "sum",
                 "samples")

    def __init__(self, name: str, help: str = "", buckets=TIME_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)   # last = +Inf overflow
        self.count = 0
        self.sum = 0.0
        self.samples: list[float] = []

    def observe(self, x: float):
        x = float(x)
        self.count += 1
        self.sum += x
        self.samples.append(x)
        for i, b in enumerate(self.buckets):
            if x <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        """Exact q-th percentile (0..100) of the raw samples; 0.0 when
        empty (metrics scraped before the first observation must not
        divide by zero or crash)."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        # linear interpolation between closest ranks (= np.percentile
        # default), so rows match the capture this histogram replaced
        pos = (len(xs) - 1) * q / 100.0
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)

    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Named instruments with idempotent registration and two expositions.

    ``counter``/``gauge``/``histogram`` return the existing instrument when
    the name is already registered, so call sites don't need to coordinate
    creation order. A single lock guards registration (the serving engine
    is single-threaded, but an HTTP scraper thread may read concurrently).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: dict[str, Counter] = {}
        self.gauges: dict[str, Gauge] = {}
        self.histograms: dict[str, Histogram] = {}

    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            if name not in self.counters:
                self.counters[name] = Counter(name, help)
            return self.counters[name]

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            if name not in self.gauges:
                self.gauges[name] = Gauge(name, help)
            return self.gauges[name]

    def histogram(self, name: str, help: str = "",
                  buckets=TIME_BUCKETS) -> Histogram:
        with self._lock:
            if name not in self.histograms:
                self.histograms[name] = Histogram(name, help, buckets)
            return self.histograms[name]

    def reset(self):
        """Zero every instrument in place (handles stay valid): benchmarks
        warm an engine, reset, then measure — same pattern as warming a
        jit cache."""
        for c in self.counters.values():
            c.value = 0.0
        for g in self.gauges.values():
            g.value = 0.0
        for h in self.histograms.values():
            h.counts = [0] * (len(h.buckets) + 1)
            h.count, h.sum = 0, 0.0
            h.samples = []

    # -- exposition ---------------------------------------------------------

    def to_dict(self) -> dict:
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for n, c in sorted(self.counters.items()):
            out["counters"][n] = c.value
        for n, g in sorted(self.gauges.items()):
            out["gauges"][n] = g.value
        for n, h in sorted(self.histograms.items()):
            cum, buckets = 0, {}
            for b, c in zip(h.buckets, h.counts):
                cum += c
                buckets[f"{b:g}"] = cum
            buckets["+Inf"] = h.count
            out["histograms"][n] = {
                "count": h.count, "sum": h.sum, "mean": h.mean(),
                "p50": h.percentile(50), "p99": h.percentile(99),
                "buckets": buckets}
        return out

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []

        def head(name, help, kind):
            if help:
                lines.append(f"# HELP {name} {help}")
            lines.append(f"# TYPE {name} {kind}")

        for n, c in sorted(self.counters.items()):
            head(n, c.help, "counter")
            lines.append(f"{n} {c.value:g}")
        for n, g in sorted(self.gauges.items()):
            head(n, g.help, "gauge")
            lines.append(f"{n} {g.value:g}")
        for n, h in sorted(self.histograms.items()):
            head(n, h.help, "histogram")
            cum = 0
            for b, c in zip(h.buckets, h.counts):
                cum += c
                lines.append(f'{n}_bucket{{le="{b:g}"}} {cum}')
            lines.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            lines.append(f"{n}_sum {h.sum:g}")
            lines.append(f"{n}_count {h.count}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# tracer (Chrome trace-event JSON; loads in Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------

# pid lanes: one for the engine's tick phases, one holding a thread per
# request — metadata events below name them in the viewer
ENGINE_PID = 1
REQUEST_PID = 2


class Tracer:
    """Collects Chrome trace events. All timestamps come from the caller
    (``Telemetry.clock()``, i.e. perf_counter seconds); the tracer shifts
    them to microseconds since its own epoch at append time."""

    def __init__(self, *, epoch: float | None = None):
        self.epoch = time.perf_counter() if epoch is None else epoch
        self.events: list[dict] = [
            {"ph": "M", "name": "process_name", "pid": ENGINE_PID,
             "tid": 0, "args": {"name": "engine"}},
            {"ph": "M", "name": "process_name", "pid": REQUEST_PID,
             "tid": 0, "args": {"name": "requests"}},
        ]
        self._named_tids: set[int] = set()

    def _us(self, t: float) -> float:
        return (t - self.epoch) * 1e6

    def name_request(self, rid: int):
        if rid in self._named_tids:
            return
        self._named_tids.add(rid)
        self.events.append({"ph": "M", "name": "thread_name",
                            "pid": REQUEST_PID, "tid": rid,
                            "args": {"name": f"req {rid}"}})

    def span(self, name: str, t0: float, t1: float, *, pid: int = ENGINE_PID,
             tid: int = 0, args: dict | None = None):
        """One complete ("X") span from t0 to t1 (perf_counter seconds)."""
        ev = {"ph": "X", "name": name, "pid": pid, "tid": tid,
              "ts": self._us(t0), "dur": max(0.0, (t1 - t0) * 1e6)}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, t: float, *, pid: int = REQUEST_PID,
                tid: int = 0, args: dict | None = None):
        ev = {"ph": "i", "name": name, "pid": pid, "tid": tid,
              "ts": self._us(t), "s": "t"}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def clear(self):
        meta = [e for e in self.events if e["ph"] == "M"]
        self.events = meta

    def to_chrome_trace(self) -> dict:
        return {"traceEvents": list(self.events), "displayTimeUnit": "ms"}

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_chrome_trace(), **kw)


# ---------------------------------------------------------------------------
# facade the engine talks to
# ---------------------------------------------------------------------------

class Telemetry:
    """Registry + tracer behind the hook surface ``ServeEngine`` calls.

    Per-request state (arrival stamp, last-token stamp, emitted count) is
    keyed by rid and kept for the engine's lifetime — a few floats per
    request, and it is what lets a metrics scrape *during* a request
    still be self-consistent. Every hook takes ``now`` so one tick can
    stamp all its events with one clock read.
    """

    def __init__(self, *, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.tracer = tracer if tracer is not None else Tracer()
        r = self.registry
        self.requests = r.counter(
            "serve_requests_total", "requests accepted by add_request")
        self.finished = r.counter(
            "serve_finished_total", "requests finished (evicted)")
        self.tokens = r.counter(
            "serve_tokens_total", "generated tokens emitted")
        self.ttft = r.histogram(
            "serve_ttft_seconds", "arrival to first generated token")
        self.itl = r.histogram(
            "serve_itl_seconds", "inter-token gap after the first token")
        self.queue_wait = r.histogram(
            "serve_queue_wait_seconds",
            "arrival to prefill start (the admission decision) — prefill "
            "time itself is TTFT's, not the queue's")
        self.prefill_s = r.histogram(
            "serve_prefill_wave_seconds", "one admission prefill wave")
        self.prefill_slice_s = r.histogram(
            "serve_prefill_slice_seconds",
            "one interleaved prefill slice (chunked admission work "
            "co-scheduled with decode ticks)")
        self.decode_s = r.histogram(
            "serve_decode_tick_seconds", "one batched decode tick")
        self.spec_s = r.histogram(
            "serve_spec_wave_seconds",
            "one fused draft+verify speculative wave")
        # lifecycle state, keyed by rid
        self._arrive: dict[int, float] = {}
        self._admit_t: dict[int, float] = {}
        self._last_tok: dict[int, float] = {}
        self._emitted: dict[int, int] = {}

    @staticmethod
    def clock() -> float:
        return time.perf_counter()

    def reset(self):
        """Zero metrics and drop trace events (per-request state of still-
        live requests survives, so TTFT for an in-flight request spans the
        reset honestly)."""
        self.registry.reset()
        self.tracer.clear()

    # -- engine hooks -------------------------------------------------------

    def engine_started(self, *, kv_bytes: int, kv_bytes_per_device: int,
                       max_batch: int, n_blocks: int | None = None,
                       byte_breakdown: dict | None = None):
        g = self.registry.gauge
        g("kv_pool_bytes", "resident bytes of the KV pool").set(kv_bytes)
        g("kv_pool_bytes_per_device",
          "per-device shard of the KV pool").set(kv_bytes_per_device)
        g("serve_max_batch", "decode slot count").set(max_batch)
        if n_blocks is not None:
            g("kv_blocks_total", "paged pool physical blocks").set(n_blocks)
        for role, b in (byte_breakdown or {}).items():
            g(f"kv_pool_{role}_bytes",
              f"resident KV pool bytes in {role} leaves").set(b)

    def request_added(self, rid: int, prompt_len: int,
                      now: float | None = None):
        now = self.clock() if now is None else now
        self.requests.inc()
        self._arrive[rid] = now
        self._emitted[rid] = 0
        self.tracer.name_request(rid)
        self.tracer.instant("queued", now, tid=rid,
                            args={"prompt_len": prompt_len})

    def request_admitted(self, rid: int, *, slot: int, prefilled_tokens: int,
                         cached_tokens: int = 0, now: float | None = None):
        """``now`` is when this request's prefill STARTED (the admission
        decision), not when the wave returned — the engine used to stamp
        the wave's end here, which silently booked the whole prefill into
        queue-wait on top of TTFT. Attribution after the audit: queue_wait
        = arrival -> prefill start; TTFT = arrival -> first token (prefill
        included, counted once)."""
        now = self.clock() if now is None else now
        t0 = self._arrive.get(rid, now)
        self.queue_wait.observe(now - t0)
        self._admit_t[rid] = now
        self.tracer.span("queued", t0, now, pid=REQUEST_PID, tid=rid)
        self.tracer.instant(
            "admitted", now, tid=rid,
            args={"slot": slot, "prefilled_tokens": prefilled_tokens,
                  "cached_tokens": cached_tokens})

    def tokens_emitted(self, rid: int, n: int, now: float | None = None):
        """``n`` tokens landed for ``rid`` this tick. The first ever closes
        TTFT; later ones each contribute one ITL gap — a speculative wave
        banking k tokens in one tick contributes k gaps of tick/k, the
        same convention the hand-rolled bench capture used.

        Attribution: a request's own prefill lands in its
        TTFT only — but whatever stalls the tick between two of a
        *decoding* request's tokens (a blocking co-admission wave, a
        kernel build or graph capture, a GC pause) lands in that request's ITL gap, honestly.
        That is the measurement that exposed the head-of-line bug:
        interleaved prefill slicing shrinks the per-tick stall to one
        slice, and these gaps are where the fix shows up."""
        if n <= 0 or rid not in self._arrive:
            return
        now = self.clock() if now is None else now
        prev = self._emitted.get(rid, 0)
        gaps = n
        if prev == 0:
            self.ttft.observe(now - self._arrive[rid])
            self.tracer.instant("first_token", now, tid=rid)
            self._last_tok[rid] = now
            gaps -= 1
        if gaps:
            gap = (now - self._last_tok[rid]) / gaps
            for _ in range(gaps):
                self.itl.observe(gap)
        self._last_tok[rid] = now
        self._emitted[rid] = prev + n
        self.tokens.inc(n)

    def request_finished(self, rid: int, reason: str,
                         now: float | None = None):
        now = self.clock() if now is None else now
        self.finished.inc()
        start = self._admit_t.pop(rid, self._arrive.get(rid, now))
        self.tracer.span("generate", start, now, pid=REQUEST_PID, tid=rid,
                         args={"reason": reason,
                               "tokens": self._emitted.get(rid, 0)})
        self.tracer.instant("finished", now, tid=rid,
                            args={"reason": reason})
        self._arrive.pop(rid, None)
        self._last_tok.pop(rid, None)
        self._emitted.pop(rid, None)

    def prefill_wave(self, t0: float, *, n_reqs: int, bucket: int,
                     now: float | None = None):
        now = self.clock() if now is None else now
        self.prefill_s.observe(now - t0)
        self.tracer.span("prefill_wave", t0, now,
                         args={"n_reqs": n_reqs, "bucket": bucket})

    def prefill_slice(self, t0: float, *, n_reqs: int, tokens: int,
                      bucket: int, now: float | None = None):
        """One interleaved prefill slice (a chunk of an admission group's
        prompt run alongside the decode batch). Sliced admissions book
        these instead of one prefill_wave span — the wave no longer exists
        as a contiguous blocking interval."""
        now = self.clock() if now is None else now
        self.prefill_slice_s.observe(now - t0)
        self.tracer.span("prefill_slice", t0, now,
                         args={"n_reqs": n_reqs, "tokens": tokens,
                               "bucket": bucket})

    def decode_tick(self, t0: float, *, n_active: int,
                    now: float | None = None):
        now = self.clock() if now is None else now
        self.decode_s.observe(now - t0)
        self.tracer.span("decode_tick", t0, now,
                         args={"n_active": n_active})

    def spec_wave(self, t0: float, *, n_active: int, k: int, accepted: int,
                  now: float | None = None):
        now = self.clock() if now is None else now
        self.spec_s.observe(now - t0)
        self.tracer.span("spec_wave", t0, now,
                         args={"n_active": n_active, "k": k,
                               "accepted": accepted})

    def update_gauges(self, values: dict):
        g = self.registry.gauge
        for name, v in values.items():
            g(name).set(v)

    # -- exports ------------------------------------------------------------

    def metrics_json(self, **kw) -> str:
        return self.registry.to_json(**kw)

    def metrics_prometheus(self) -> str:
        return self.registry.to_prometheus()

    def chrome_trace(self) -> dict:
        return self.tracer.to_chrome_trace()

    # -- human-readable one-liner (the launcher's periodic stats line) ------

    def summary_line(self) -> str:
        r = self.registry
        done = r.counter("serve_finished_total").value
        toks = r.counter("serve_tokens_total").value
        occ = r.gauge("serve_slots_occupied").value
        qd = r.gauge("serve_queue_depth").value
        parts = [f"done={done:g}", f"tokens={toks:g}",
                 f"slots={occ:g}", f"queue={qd:g}",
                 f"ttft_p50={self.ttft.percentile(50) * 1e3:.1f}ms",
                 f"itl_p50={self.itl.percentile(50) * 1e3:.1f}ms"]
        if self.spec_s.count:
            acc = r.gauge("serve_spec_acceptance").value
            parts.append(f"spec_acc={acc * 100:.1f}%")
        return " ".join(parts)


# ---------------------------------------------------------------------------
# device-trace hook (opt-in; the one place torch enters this module)
# ---------------------------------------------------------------------------

_profiler_warned = False


def start_torch_profiler(logdir: str):
    """Start a ``torch.profiler`` trace (host ops and, where a card is
    visible, its kernels) that writes a Chrome trace into ``logdir`` when
    stopped.

    Returns the running profiler, or False when it could not start: then
    this warns ONCE per process — a missing profiler must never take the
    serve loop down with it.
    """
    global _profiler_warned
    try:
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(logdir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        prof.logdir = logdir
        return prof
    except Exception as e:  # noqa: BLE001 - platform-dependent failure set
        if not _profiler_warned:
            _profiler_warned = True
            warnings.warn(
                f"--torch-profile requested but the device profiler is "
                f"unavailable here ({e!r}); serving continues without a "
                "device trace", RuntimeWarning, stacklevel=2)
        return False


def stop_torch_profiler(started) -> str | None:
    """Stop a profiler ``start_torch_profiler`` returned and write its
    Chrome trace into its directory; -> the trace's path (None when it
    never started)."""
    if not started:
        return None
    import os
    started.stop()
    path = os.path.join(started.logdir, f"torch_trace_{os.getpid()}.json")
    started.export_chrome_trace(path)
    return path
