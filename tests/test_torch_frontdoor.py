"""The port's HTTP/SSE front door (launch/server.py), with the checks of
tests/test_frontdoor.py on the port's smoke model: concurrent streams are
token-identical to the direct engine, over-long prompts answer 400 with the
AdmissionError body, a full admission queue answers 429 + Retry-After, and
shutdown is cooperative — no thread left blocking on a dead peer.
"""

import json
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.launch.server import FrontDoor  # noqa: E402
from repro_torch.models import get_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.serving.telemetry import Telemetry  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    cfg = smoke_config("stablelm-3b")
    api = get_model(cfg)
    return cfg, api, api.init(0, device="cpu")


def _engine(api, params, **kw):
    return ServeEngine(api, params, max_batch=2, max_len=64,
                       interleave=True, prefill_chunk=8,
                       telemetry=Telemetry(), **kw)


def _post(base, body, timeout=60):
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def _sse_tokens(base, body, stamps=None):
    toks, done = [], None
    with _post(base, dict(body, stream=True)) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r:
            line = line.decode().strip()
            if not line.startswith("data: "):
                continue
            ev = json.loads(line[len("data: "):])
            if "token" in ev:
                toks.append(ev["token"])
                if stamps is not None:
                    stamps.append(time.perf_counter())
            else:
                done = ev
    return toks, done


def test_concurrent_sse_streams_match_engine(model):
    """Two SSE clients stream concurrently; each gets exactly the tokens
    a direct engine call produces, the per-token arrivals of the two
    streams overlap in time (they decode in one batch, not serially), and
    the server shuts down cleanly afterwards."""
    cfg, api, params = model
    prompts = [list(range(1, 9)), list(range(3, 15))]
    ref_eng = _engine(api, params)
    rids = [ref_eng.add_request(np.asarray(p, np.int32), max_new=16)
            for p in prompts]
    ref = [ref_eng.run()[r] for r in rids]

    fd = FrontDoor(_engine(api, params), port=0, queue_limit=8).start()
    base = f"http://{fd.host}:{fd.port}"
    try:
        out = [None, None]
        windows = [[], []]

        def client(i):
            out[i] = _sse_tokens(base, {"prompt": prompts[i],
                                        "max_new": 16},
                                 stamps=windows[i])

        ts = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
        for i in (0, 1):
            toks, done = out[i]
            assert toks == ref[i], i
            assert done == {"done": True, "tokens": ref[i]}
        # interleaved arrival: the two token streams' time windows overlap
        assert max(windows[0][0], windows[1][0]) \
            < min(windows[0][-1], windows[1][-1])
    finally:
        t0 = time.perf_counter()
        fd.close()
    assert time.perf_counter() - t0 < 10.0
    assert not any(t.name.startswith("frontdoor") for t in threading.enumerate())


def test_overlong_prompt_answers_400(model):
    cfg, api, params = model
    fd = FrontDoor(_engine(api, params), port=0).start()
    base = f"http://{fd.host}:{fd.port}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": list(range(200)), "max_new": 4})
        assert ei.value.code == 400
        body = json.loads(ei.value.read())
        assert body["error"]["code"] == "prompt_too_long"
        assert body["error"]["detail"]["limit"] == 64
        # a token id outside the vocabulary is refused before the engine
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": [1, cfg.vocab], "max_new": 4})
        assert ei.value.code == 400
        assert json.loads(ei.value.read())["error"]["code"] == "bad_token"
        # malformed body is a 400 too, not a socket drop
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": "not a token list"})
        assert ei.value.code == 400
        assert json.loads(ei.value.read())["error"]["code"] == "bad_request"
        # the engine is unharmed: a valid request still serves
        toks, done = _sse_tokens(base, {"prompt": [1, 2, 3], "max_new": 4})
        assert len(toks) == 4 and done["done"] is True
    finally:
        fd.close()


def test_queue_overflow_answers_429(model):
    """queue_limit=1 and no engine loop draining: the first submission
    fills the inbox, the second bounces with 429 + Retry-After instead of
    buffering without bound."""
    cfg, api, params = model
    fd = FrontDoor(_engine(api, params), port=0, queue_limit=1)
    fd.start(engine_loop=False)
    base = f"http://{fd.host}:{fd.port}"
    errs = queue.Queue()

    def occupant():
        # parks in the inbox forever (nobody drains); answered 503 at close
        try:
            _post(base, {"prompt": [1, 2], "max_new": 4}, timeout=60)
        except Exception as e:  # noqa: BLE001 - recorded, asserted below
            errs.put(e)

    t = threading.Thread(target=occupant, daemon=True)
    t.start()
    deadline = time.time() + 10
    while fd._inbox.empty() and time.time() < deadline:
        time.sleep(0.01)
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, {"prompt": [3, 4], "max_new": 4})
        assert ei.value.code == 429
        assert ei.value.headers["Retry-After"] == "1"
        assert json.loads(ei.value.read())["error"]["code"] == "overloaded"
    finally:
        fd.close()
    t.join(timeout=10)
    assert not t.is_alive()
    e = errs.get(timeout=5)            # occupant got the shutdown 503
    assert isinstance(e, urllib.error.HTTPError) and e.code == 503


def test_healthz_and_metrics(model):
    cfg, api, params = model
    fd = FrontDoor(_engine(api, params), port=0).start()
    base = f"http://{fd.host}:{fd.port}"
    try:
        assert json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read()) == {"ok": True}
        _sse_tokens(base, {"prompt": [1, 2, 3], "max_new": 4})
        text = urllib.request.urlopen(
            base + "/metrics", timeout=10).read().decode()
        assert "serve_tokens_total 4" in text
        assert "serve_ttft_seconds" in text
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        fd.close()


def test_failed_tick_reaches_clients_and_healthz(model):
    """A tick that raises stops the engine thread; the waiting SSE and
    JSON clients get the failure (an error event, a 503) instead of
    hanging, /healthz answers 503 and a new POST is refused with 503."""
    cfg, api, params = model
    eng = _engine(api, params)

    def step():
        raise RuntimeError("tick failed")

    eng.step = step
    fd = FrontDoor(eng, port=0).start()
    base = f"http://{fd.host}:{fd.port}"
    try:
        toks, done = _sse_tokens(base, {"prompt": [1, 2, 3], "max_new": 4})
        assert toks == []
        assert done["error"]["code"] == "engine_failed"
        assert "tick failed" in done["error"]["message"]
        for url, body in ((base + "/healthz", None),
                          (base + "/v1/generate", b'{"prompt": [1], "max_new": 2}')):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(urllib.request.Request(url, data=body),
                                       timeout=10)
            assert ei.value.code == 503
            assert json.loads(ei.value.read())["error"]["code"] == "engine_failed"
    finally:
        fd.close()
    assert not any(t.name.startswith("frontdoor") for t in threading.enumerate())


def test_launcher_http_mode_serves_and_flushes_on_sigint(tmp_path):
    """``python -m repro_torch.launch.serve --http 0`` binds a free port and
    logs it, answers /healthz and a JSON request, and on SIGINT exits 0
    with the metrics file written."""
    import os
    import re
    import signal
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    metrics = tmp_path / "m.json"
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--prompt-lens", "8", "--max-new", "4", "--http", "0",
         "--metrics-out", str(metrics)],
        cwd=root, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(root / "src")})
    watchdog = threading.Timer(120, proc.kill)     # a hung server fails, not hangs
    watchdog.start()
    try:
        base = None
        for line in proc.stderr:
            m = re.search(r"serving on (http://[\d.]+:\d+)", line)
            if m:
                base = m.group(1)
                break
        assert base is not None
        assert json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=30).read()) == {"ok": True}
        with _post(base, {"prompt": [1, 2, 3], "max_new": 4}) as r:
            assert len(json.loads(r.read())["tokens"]) == 4
        proc.send_signal(signal.SIGINT)
        proc.stderr.read()
        assert proc.wait(timeout=60) == 0
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert json.loads(metrics.read_text())["counters"]["serve_tokens_total"] == 4
