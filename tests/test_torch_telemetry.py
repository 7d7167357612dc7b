"""Serving telemetry in the port (serving/telemetry.py), mirroring
tests/test_telemetry.py: the instruments, the same event sequence giving
repro's JSON, Prometheus text and Chrome trace, the engine's metrics and
trace on a real run, the stats schema, and the overhead contract —
telemetry on and off give the same tokens and the same calls into the
model (on the CPU the kernel wrappers count nothing; on a card
tests/test_torch_cuda.py holds the launches and replays). Also the
launcher's telemetry flags, run in-process on the smoke model."""

import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import telemetry as JT  # noqa: E402
from repro.serving.engine import STATS_SCHEMA as JAX_STATS_SCHEMA  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving import telemetry as T  # noqa: E402
from repro_torch.serving.engine import STATS_SCHEMA, ServeEngine  # noqa: E402
from repro_torch.serving.telemetry import MetricsRegistry, Telemetry, Tracer  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    return cfg, api, api.init(0, device="cpu")


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

def test_counter_and_log_buckets():
    c = MetricsRegistry().counter("c")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    with pytest.raises(ValueError):
        c.inc(-1)
    bs = T.log_buckets(1e-3, 1.0)
    assert bs[0] == 1e-3 and bs[-1] >= 1.0
    assert all(b2 / b1 == pytest.approx(2.0) for b1, b2 in zip(bs, bs[1:]))
    with pytest.raises(ValueError):
        T.log_buckets(0.0, 1.0)


def test_histogram_percentiles_buckets_and_empty():
    h = T.Histogram("h")
    assert h.percentile(50) == h.percentile(99) == h.mean() == 0.0
    xs = np.random.default_rng(0).exponential(0.01, size=257)
    for x in xs:
        h.observe(float(x))
    for q in (0, 25, 50, 99, 100):
        assert h.percentile(q) == pytest.approx(np.percentile(xs, q))
    assert h.mean() == pytest.approx(xs.mean()) and h.count == len(xs)
    h = T.Histogram("h", buckets=(0.1, 1.0, 10.0))
    for x in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(x)
    reg = MetricsRegistry()
    reg.histograms["h"] = h
    assert reg.to_dict()["histograms"]["h"]["buckets"] == {"0.1": 1, "1": 3, "10": 4,
                                                            "+Inf": 5}


def test_registry_idempotent_and_reset():
    r = MetricsRegistry()
    assert r.counter("a") is r.counter("a") and r.gauge("g") is r.gauge("g")
    r.counter("a").inc(3)
    r.gauge("g").set(7)
    h = r.histogram("h")
    h.observe(0.5)
    r.reset()
    assert r.counter("a").value == r.gauge("g").value == 0.0
    assert h.count == 0 and h.samples == [] and h is r.histogram("h")


def test_tracer_chrome_trace_schema():
    tr = Tracer(epoch=0.0)
    tr.name_request(3)
    tr.name_request(3)                       # idempotent
    tr.span("decode_tick", 1.0, 1.5, args={"n_active": 2})
    tr.instant("first_token", 1.2, tid=3)
    evs = tr.to_chrome_trace()["traceEvents"]
    assert sum(1 for e in evs if e["ph"] == "M" and e["name"] == "thread_name") == 1
    (span,) = [e for e in evs if e["ph"] == "X"]
    assert span["ts"] == pytest.approx(1.0e6) and span["dur"] == pytest.approx(0.5e6)
    tr.clear()
    assert len(tr.events) == 3 and all(e["ph"] == "M" for e in tr.events)


def test_tokens_emitted_ttft_and_itl_convention():
    tm = Telemetry()
    tm.request_added(0, prompt_len=4, now=10.0)
    tm.tokens_emitted(0, 3, now=10.5)        # the first tick banks 3 tokens
    assert tm.ttft.samples == [pytest.approx(0.5)] and tm.itl.samples == [0.0, 0.0]
    tm.tokens_emitted(0, 4, now=10.9)        # a spec wave: 4 gaps of 0.1
    assert tm.itl.samples[2:] == [pytest.approx(0.1)] * 4
    tm.tokens_emitted(99, 1, now=11.0)       # unknown rid: no-op
    tm.request_finished(0, "max_new", now=11.0)
    assert tm.tokens.value == 7 and tm.finished.value == 1 and 0 not in tm._arrive


def _events(tm):
    """One request lifecycle through every hook, at fixed clock values."""
    tm.engine_started(kv_bytes=1024, kv_bytes_per_device=1024, max_batch=2, n_blocks=16,
                      byte_breakdown={"values": 1000, "scales": 16, "index": 8})
    tm.request_added(0, 12, now=1.0)
    tm.request_added(1, 5, now=1.25)
    tm.prefill_slice(1.5, n_reqs=2, tokens=8, bucket=16, now=1.75)
    tm.prefill_wave(1.75, n_reqs=1, bucket=8, now=2.0)
    tm.request_admitted(0, slot=0, prefilled_tokens=12, cached_tokens=4, now=1.5)
    tm.request_admitted(1, slot=1, prefilled_tokens=5, now=1.75)
    tm.tokens_emitted(0, 1, now=2.0)
    tm.tokens_emitted(1, 1, now=2.0)
    tm.decode_tick(2.0, n_active=2, now=2.125)
    tm.tokens_emitted(0, 1, now=2.125)
    tm.spec_wave(2.125, n_active=2, k=3, accepted=2, now=2.5)
    tm.tokens_emitted(0, 3, now=2.5)
    tm.tokens_emitted(1, 2, now=2.5)
    tm.update_gauges({"serve_slots_occupied": 2, "serve_queue_depth": 0,
                      "serve_spec_acceptance": 0.5})
    tm.request_finished(1, "stop", now=2.75)
    tm.request_finished(0, "max_new", now=3.0)


def test_same_events_give_repro_outputs():
    """JSON, Prometheus text, Chrome trace and the summary line, equal to
    repro's Telemetry's for the same hook calls at the same clocks."""
    ours, theirs = Telemetry(tracer=Tracer(epoch=0.5)), JT.Telemetry(tracer=JT.Tracer(epoch=0.5))
    _events(ours)
    _events(theirs)
    assert ours.metrics_json(indent=2) == theirs.metrics_json(indent=2)
    assert ours.metrics_prometheus() == theirs.metrics_prometheus()
    assert ours.chrome_trace() == theirs.chrome_trace()
    assert ours.summary_line() == theirs.summary_line()


# ---------------------------------------------------------------------------
# the engine: metrics and trace of real runs
# ---------------------------------------------------------------------------

def _spans(tm, pid):
    return [e for e in tm.chrome_trace()["traceEvents"] if e["ph"] == "X" and e["pid"] == pid]


def test_engine_metrics_and_trace(model):
    cfg, api, params = model
    tm = Telemetry()
    eng = ServeEngine(api, params, max_batch=2, max_len=64, kv_block_size=8,
                      prefix_cache=True, telemetry=tm)
    # rid 2 admits in a later wave and hits the block the first wave published
    rids = [eng.add_request(np.arange(12) % cfg.vocab, max_new=mn) for mn in (3, 6, 3)]
    assert set(eng.run()) == set(rids)
    m = json.loads(tm.metrics_json())
    assert m["counters"]["serve_requests_total"] == m["counters"]["serve_finished_total"] == 3
    assert m["counters"]["serve_tokens_total"] == eng.stats["generated_tokens"]
    h = m["histograms"]
    assert h["serve_ttft_seconds"]["count"] == h["serve_queue_wait_seconds"]["count"] == 3
    assert h["serve_itl_seconds"]["count"] == eng.stats["generated_tokens"] - 3
    assert h["serve_decode_tick_seconds"]["count"] == eng.stats["decode_steps"]
    assert h["serve_prefill_wave_seconds"]["count"] == eng.stats["prefills"]
    assert m["gauges"]["kv_pool_bytes"] == eng.stats["kv_bytes"]
    assert m["gauges"]["kv_blocks_total"] == eng.n_blocks
    assert m["gauges"]["serve_prefix_hit_rate"] > 0.0
    assert m["counters"]["prefix_hits_total"] > 0 and m["counters"]["sched_selects_total"] > 0
    assert {e["name"] for e in _spans(tm, T.REQUEST_PID)} == {"queued", "generate"}
    assert {e["name"] for e in _spans(tm, T.ENGINE_PID)} == {"prefill_wave", "decode_tick"}


def test_engine_interleave_and_spec_metrics(model):
    """Interleaved prefill books prefill_slice spans, never a blocking
    prefill_wave; a spec engine books spec_wave spans, never a decode_tick."""
    cfg, api, params = model
    tm = Telemetry()
    eng = ServeEngine(api, params, max_batch=2, max_len=64, interleave=True,
                      prefill_chunk=4, telemetry=tm)
    eng.add_request(np.arange(12) % cfg.vocab, max_new=3)
    eng.add_request(np.arange(9) % cfg.vocab, max_new=3)
    eng.run()
    m = json.loads(tm.metrics_json())
    assert m["histograms"]["serve_prefill_slice_seconds"]["count"] == \
        eng.stats["prefill_slices"] > 0
    assert m["histograms"]["serve_prefill_wave_seconds"]["count"] == 0
    assert m["gauges"]["serve_prefill_jobs"] == 0.0
    assert "prefill_wave" not in {e["name"] for e in _spans(tm, T.ENGINE_PID)}
    tm = Telemetry()
    eng = ServeEngine(api, params, max_batch=2, max_len=64, spec_k=2, telemetry=tm)
    eng.add_request(np.arange(6), max_new=6)
    eng.add_request(np.arange(6), max_new=6)
    eng.run()
    m = json.loads(tm.metrics_json())
    assert m["histograms"]["serve_spec_wave_seconds"]["count"] == eng.stats["spec_waves"]
    assert m["histograms"]["serve_decode_tick_seconds"]["count"] == 0
    assert m["counters"]["serve_tokens_total"] == eng.stats["generated_tokens"]
    assert m["gauges"]["serve_spec_acceptance"] == pytest.approx(eng.acceptance_rate())


# ---------------------------------------------------------------------------
# the overhead contract
# ---------------------------------------------------------------------------

# every model function the engine calls, the decode and the verify inside
# the tick's and the wave's step function included
_MODEL_FNS = ("prefill", "prefill_ctx", "prefill_chunked", "decode", "verify", "cache_insert",
              "prefill_slice_init", "prefill_slice", "prefill_slice_finish")


def _counting(api):
    counts = dict.fromkeys(_MODEL_FNS, 0)

    def shim(name):
        fn = getattr(api, name)

        def call(*args, **kw):
            counts[name] += 1
            return fn(*args, **kw)
        return call
    return api._replace(**{name: shim(name) for name in _MODEL_FNS}), counts


@pytest.mark.parametrize("kw", [
    {},
    {"kv_block_size": 8, "prefix_cache": True},
    {"spec_k": 2},
    {"interleave": True, "prefill_chunk": 4},
], ids=["contig", "paged_prefix", "spec", "interleave"])
def test_telemetry_on_off_same_tokens_and_model_calls(model, kw):
    cfg, api, params = model

    def drive(telemetry):
        capi, counts = _counting(api)
        eng = ServeEngine(capi, params, max_batch=2, max_len=64, temperature=0.7, seed=11,
                          telemetry=telemetry, **kw)
        rids = [eng.add_request(np.arange(p) % cfg.vocab, max_new=mn)
                for p, mn in [(8, 5), (8, 7), (5, 3), (11, 4)]]
        res = eng.run()
        return {r: res[r] for r in rids}, counts, dict(eng.stats)

    toks_off, n_off, stats_off = drive(None)
    toks_on, n_on, stats_on = drive(Telemetry())
    assert toks_on == toks_off and n_on == n_off and stats_on == stats_off
    assert n_on["decode" if "spec_k" not in kw else "verify"] > 0


@pytest.mark.parametrize("kw", [
    {},
    {"kv_block_size": 8, "prefix_cache": True},
    {"spec_k": 2},
    {"interleave": True, "prefill_chunk": 4},
], ids=["contig", "paged_prefix", "spec", "interleave"])
def test_stats_schema_equals_repro(model, kw):
    cfg, api, params = model
    eng = ServeEngine(api, params, max_batch=2, max_len=64, **kw)
    eng.add_request(np.arange(8), max_new=3)
    eng.run()
    assert set(eng.stats) == set(STATS_SCHEMA) == set(JAX_STATS_SCHEMA)
    for key, (typ, doc) in STATS_SCHEMA.items():
        assert isinstance(eng.stats[key], typ) and typ is JAX_STATS_SCHEMA[key][0] and doc
    assert eng.stats["kv_bytes_per_device"] == eng.stats["kv_bytes"]


def test_ratios_guarded_before_first_tick(model):
    cfg, api, params = model
    tm = Telemetry()
    eng = ServeEngine(api, params, max_batch=2, max_len=64, spec_k=2, kv_block_size=8,
                      prefix_cache=True, telemetry=tm)
    assert eng.acceptance_rate() == eng.utilization() == 0.0
    g = eng._telemetry_gauges()
    assert g["serve_slot_occupancy"] == g["serve_prefix_hit_rate"] == \
        g["serve_spec_acceptance"] == 0.0
    assert json.loads(tm.metrics_json())["histograms"]["serve_ttft_seconds"]["p50"] == 0.0
    assert "ttft_p50=0.0ms" in tm.summary_line()


# ---------------------------------------------------------------------------
# the device-trace hook
# ---------------------------------------------------------------------------

def test_torch_profiler_warns_once_and_keeps_serving(monkeypatch, tmp_path):
    import torch.profiler

    def refuse(*a, **k):
        raise RuntimeError("no profiler here")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(T, "_profiler_warned", False)
    with pytest.warns(RuntimeWarning, match="profiler is unavailable"):
        assert T.start_torch_profiler(str(tmp_path)) is False
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # a second warning would raise
        assert T.start_torch_profiler(str(tmp_path)) is False
    assert T.stop_torch_profiler(False) is None


def test_launcher_telemetry_files(tmp_path):
    """--interleave --scheduler slo with --metrics-out (JSON, then .prom),
    --trace-out, --stats-every and --torch-profile, in-process on the CPU:
    the files parse, the trace books prefill_slice spans, the profile
    directory holds a Chrome trace."""
    base = ["--smoke", "--device", "cpu", "--requests", "4", "--prompt-lens", "5,9,17",
            "--max-new", "4", "--interleave", "--scheduler", "slo", "--stats-every", "2"]
    res = serve.main(base + ["--metrics-out", str(tmp_path / "m.json"),
                             "--trace-out", str(tmp_path / "t.json"),
                             "--torch-profile", str(tmp_path / "prof")])
    assert sorted(res) == [0, 1, 2, 3] and all(len(v) == 4 for v in res.values())
    m = json.loads((tmp_path / "m.json").read_text())
    assert m["counters"]["serve_tokens_total"] == 16
    assert m["histograms"]["serve_prefill_slice_seconds"]["count"] > 0
    evs = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert "prefill_slice" in {e["name"] for e in evs if e["ph"] == "X"}
    (trace,) = list((tmp_path / "prof").iterdir())
    assert json.loads(trace.read_text())["traceEvents"]
    serve.main(base + ["--metrics-out", str(tmp_path / "m.prom")])
    assert "serve_tokens_total 16" in (tmp_path / "m.prom").read_text().splitlines()
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        serve.main(base + ["--mesh", "2"])
    # --ckpt-dir (ported with the trainer): a directory with no checkpoint
    # serves the random weights, as in the reference
    assert serve.main(base + ["--ckpt-dir", str(tmp_path / "none")]) == res
