"""Async streaming HTTP front door for the slot engine (port of
repro/launch/server.py, on the standard library's ThreadingHTTPServer).

One ``FrontDoor`` owns one ``ServeEngine`` and exposes it over HTTP with
server-sent events (SSE) for per-token streaming:

  POST /v1/generate   {"prompt": [ids], "max_new": N, "slo": "standard",
                       "stream": true}
                      -> text/event-stream of  data: {"token": t, "index": i}
                         then                 data: {"done": true,
                                                     "tokens": [...]}
                      stream=false (default) -> one JSON body at the end
  GET  /healthz       liveness probe: 200, or 503 once the engine has failed
  GET  /metrics       Prometheus text exposition of the engine's telemetry

Threading model — the engine is single-threaded by construction (its
kernel launches and CUDA graph replays, host-side slot bookkeeping), so
exactly ONE engine thread owns it: a loop that drains the admission inbox
between ticks and calls ``engine.step()``. All device work runs on that
thread, the capture of the engine's CUDA graphs (at its first tick)
included: a CUDA call from another thread during a capture would abort it.
HTTP threads (stdlib ``ThreadingHTTPServer``) never touch the engine's
tensors; they

  * pre-validate against immutable engine config via
    ``engine.check_request`` and the vocabulary size — an over-long prompt
    or a token id outside the vocabulary answers 400 with the
    ``AdmissionError``'s structured body in the HTTP thread, instead of
    detonating inside the tick loop;
  * enqueue a ``_Submission`` on a **bounded** inbox — a full inbox
    answers 429 + Retry-After immediately (backpressure, not unbounded
    buffering);
  * then block on the submission's private event queue, relaying tokens
    to the socket as the engine's per-token ``stream`` callback delivers
    them (serving/scheduler.Request.stream — the callback runs on the
    engine thread and only does a queue put).

A tick that raises ends the engine thread: on a card a failed kernel or
graph replay leaves the CUDA context broken, so a retry could only fail
again. The failure is kept; every waiting submission gets it as an error
event (503), new POSTs answer 503 and ``/healthz`` turns unhealthy.

Shutdown is cooperative: ``close()`` sets a stop event; SSE relay loops
poll it between queue gets, the engine loop exits its tick loop, and the
HTTP server is shut down — no thread blocks forever on a dead peer.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from repro_torch.serving.scheduler import AdmissionError

log = logging.getLogger("repro_torch.serving.frontdoor")

_DONE = object()          # engine finished the request (stream saw None)


class _Submission:
    """One accepted-for-queueing request: admission params + the private
    event queue its HTTP thread relays from. Events are token ids,
    ``_DONE``, or ``("error", body, status)``."""

    __slots__ = ("prompt", "max_new", "slo", "events", "rid")

    def __init__(self, prompt, max_new, slo):
        self.prompt = prompt
        self.max_new = max_new
        self.slo = slo
        self.events: queue.Queue = queue.Queue()
        self.rid = None


class FrontDoor:
    """HTTP/SSE server wrapping one engine; see module docstring."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 queue_limit: int = 64):
        if queue_limit < 1:
            raise ValueError(f"queue_limit must be >= 1, got {queue_limit}")
        self.engine = engine
        self._inbox: queue.Queue = queue.Queue(maxsize=queue_limit)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self.failure: dict | None = None     # the error body once a tick raised

        class Handler(_Handler):
            front = self

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]

    # -- lifecycle ----------------------------------------------------------

    def start(self, engine_loop: bool = True):
        """Start the HTTP listener (and, unless told otherwise, the engine
        thread). ``engine_loop=False`` is the backpressure test seam: with
        nobody draining the inbox, the bounded queue fills and 429s."""
        t = threading.Thread(target=self.httpd.serve_forever,
                             name="frontdoor-http", daemon=True)
        t.start()
        self._threads.append(t)
        if engine_loop:
            t = threading.Thread(target=self._engine_loop,
                                 name="frontdoor-engine", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def close(self):
        """Cooperative shutdown: stop the engine loop and SSE relays, then
        the HTTP server. Idempotent."""
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- engine thread ------------------------------------------------------

    def _engine_loop(self):
        """Sole owner of the engine: drain the inbox, tick, repeat. Blocks
        politely on the inbox while the engine is idle; between busy ticks
        it only polls (a waiting decode batch must not stall on arrivals).
        """
        busy = False
        while not self._stop.is_set():
            try:
                if busy:
                    sub = self._inbox.get_nowait()
                else:
                    sub = self._inbox.get(timeout=0.2)
            except queue.Empty:
                sub = None
            if sub is not None:
                self._admit(sub)
                while True:                    # drain the rest non-blocking
                    try:
                        self._admit(self._inbox.get_nowait())
                    except queue.Empty:
                        break
            try:
                busy = self.engine.step()
            except Exception as e:  # noqa: BLE001 - reported to every client
                log.exception("engine tick failed; the engine thread stops")
                self.failure = {"error": {"code": "engine_failed",
                                          "message": f"{type(e).__name__}: {e}",
                                          "detail": {}}}
                return

    def _admit(self, sub: _Submission):
        ev = sub.events

        def stream(tok, _q=ev):
            _q.put(_DONE if tok is None else int(tok))

        try:
            sub.rid = self.engine.add_request(
                sub.prompt, max_new=sub.max_new, slo=sub.slo, stream=stream)
        except AdmissionError as e:
            # raced past the HTTP-thread pre-check (config never changes,
            # so this is belt and braces): fail the one request, not the
            # engine
            ev.put(("error", e.to_dict(), 400))

    # -- HTTP-thread helpers ------------------------------------------------

    def submit(self, prompt, max_new: int, slo: str) -> _Submission:
        """Validate + enqueue; raises AdmissionError (400) or queue.Full
        (429). Runs on HTTP threads: touches immutable host config only,
        never a tensor. The caller answers 503 first where ``failure`` is
        set."""
        self.engine.check_request(len(prompt), max_new, slo)
        # the engine's check reads lengths only; an id past the vocabulary
        # would fail the embedding lookup inside a tick (on a card, a
        # device-side assert that ends the engine)
        vocab = self.engine.api.cfg.vocab
        if any(not 0 <= t < vocab for t in prompt):
            raise AdmissionError("bad_token", f"token ids must lie in [0, {vocab})",
                                 vocab=int(vocab))
        prompt = np.asarray(prompt, np.int32)
        sub = _Submission(prompt, max_new, slo)
        self._inbox.put_nowait(sub)
        return sub

    def metrics_text(self) -> str:
        tm = getattr(self.engine, "tm", None)
        if tm is None:
            return "# no telemetry attached\n"
        return tm.metrics_prometheus()


class _Handler(BaseHTTPRequestHandler):
    front: FrontDoor = None          # bound by FrontDoor.__init__ subclass
    # HTTP/1.0: the SSE response is close-delimited — no chunked framing,
    # no Content-Length, the connection ends when the stream does
    protocol_version = "HTTP/1.0"

    def log_message(self, fmt, *args):   # noqa: N802 - stdlib name
        log.debug("%s " + fmt, self.address_string(), *args)

    def _json(self, code: int, obj: dict, headers=()):
        body = (json.dumps(obj) + "\n").encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in headers:
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):                    # noqa: N802 - stdlib name
        if self.path == "/healthz":
            failure = self.front.failure
            if failure is None:
                self._json(200, {"ok": True})
            else:
                self._json(503, {"ok": False, **failure})
        elif self.path == "/metrics":
            body = self.front.metrics_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._json(404, {"error": {"code": "not_found",
                                       "message": self.path}})

    def do_POST(self):                   # noqa: N802 - stdlib name
        if self.path != "/v1/generate":
            self._json(404, {"error": {"code": "not_found",
                                       "message": self.path}})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            prompt = req["prompt"]
            if (not isinstance(prompt, list)
                    or not all(isinstance(t, int) for t in prompt)):
                raise TypeError("prompt must be a list of token ids")
            max_new = int(req.get("max_new", 16))
            slo = str(req.get("slo", "standard"))
            want_stream = bool(req.get("stream", False))
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            self._json(400, {"error": {"code": "bad_request",
                                       "message": str(e), "detail": {}}})
            return
        if self.front.failure is not None:
            self._json(503, self.front.failure)
            return
        try:
            sub = self.front.submit(prompt, max_new, slo)
        except AdmissionError as e:
            self._json(400, e.to_dict())
            return
        except queue.Full:
            self._json(429, {"error": {"code": "overloaded",
                                       "message": "admission queue full",
                                       "detail": {"queue_limit":
                                                  self.front._inbox.maxsize}}},
                       headers=(("Retry-After", "1"),))
            return
        if want_stream:
            self._relay_sse(sub)
        else:
            self._relay_json(sub)

    def _events(self, sub: _Submission):
        """Yield this submission's events until done/error/shutdown. Once
        the engine has failed and nothing is left in the queue, the last
        event is the failure, with status 503."""
        front = self.front
        while not front._stop.is_set():
            try:
                ev = sub.events.get(timeout=0.5)
            except queue.Empty:
                if front.failure is None:
                    continue
                ev = ("error", front.failure, 503)
            yield ev
            if ev is _DONE or isinstance(ev, tuple):
                return

    def _relay_json(self, sub: _Submission):
        toks = []
        for ev in self._events(sub):
            if ev is _DONE:
                self._json(200, {"rid": sub.rid, "tokens": toks})
                return
            if isinstance(ev, tuple):
                self._json(ev[2], ev[1])
                return
            toks.append(ev)
        self._json(503, {"error": {"code": "shutting_down",
                                   "message": "server stopped mid-request",
                                   "detail": {"tokens": toks}}})

    def _relay_sse(self, sub: _Submission):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-store")
        self.end_headers()
        toks = []
        try:
            for ev in self._events(sub):
                if ev is _DONE:
                    self._event({"done": True, "tokens": toks})
                    return
                if isinstance(ev, tuple):
                    self._event(ev[1])
                    return
                toks.append(ev)
                self._event({"token": ev, "index": len(toks) - 1})
            self._event({"aborted": True, "tokens": toks})
        except (BrokenPipeError, ConnectionResetError):
            # client hung up: its tokens keep draining into the private
            # queue and are garbage-collected with the submission
            log.debug("SSE client disconnected (rid %s)", sub.rid)

    def _event(self, obj: dict):
        self.wfile.write(f"data: {json.dumps(obj)}\n\n".encode())
        self.wfile.flush()
