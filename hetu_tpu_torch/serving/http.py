"""Minimal stdlib HTTP frontend for a session or micro-batcher.

A copy of ``hetu_tpu/serving/http.py`` (pure host code).

JSON in / JSON out, five routes:

* ``POST /v1/predict`` — body ``{"inputs": {feed_name: nested_list}}``;
  each input carries its batch dim. Response
  ``{"outputs": [...], "latency_ms": ..., "request_id": ...}``.
* ``GET /healthz`` — liveness (an SLO probe when SLOs are configured).
* ``GET /metrics`` — Prometheus text scrape of the serving telemetry
  (404 when telemetry is disabled).
* ``GET /v1/requests`` — live in-flight table from the backend
  (``inflight_requests()``; 404 when the backend has none).
* ``GET /stats`` — frontend + backend snapshot (``stats()``), the
  queue-depth / KV-pressure / compile-accounting view a fleet
  dashboard scrapes.

**Request ids.** Ingress is where the end-to-end tracing id is born: a
client-supplied ``x-request-id`` header is honored, otherwise one is
minted (``serving/lifecycle.py``), and every response echoes it back in
the ``X-Request-Id`` header and the JSON body — including errors, so a
user-reported failure is greppable straight into the trace and the
in-flight dumps. Backends whose ``submit`` accepts ``request_id=``
(engine, batcher, router) get it passed through.

**Overload is not a 500.** ``EngineOverloaded`` maps to 429 and
``RouterOverloaded`` / ``KVCacheExhausted`` to 503, each with a
structured JSON body (``error``, ``request_id``, ``retry_after_ms``)
and a ``Retry-After`` header — the backpressure signal a client can
act on, where a bare 500 just looks broken. Shed requests still count
against the error SLO: a shedding replica *should* drain out of the
router rotation.

The backend is either an :class:`InferenceSession` (each request runs
its own forward) or anything with ``submit(...) -> Future`` (a
:class:`MicroBatcher`, a :class:`ContinuousBatchingEngine` front, a
:class:`ReplicaRouter` — the stack the ``serve_dense`` pass of
``chip_smoke.py`` drives). A production frontend would speak gRPC;
this is deliberately the smallest thing that lets a multi-threaded
closed-loop client exercise the batching + bucketing stack end to end.
"""
from __future__ import annotations

import inspect
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import telemetry as _telemetry
from .kvcache import KVCacheExhausted
from .lifecycle import mint_request_id
from .router import RouterOverloaded, SLOWindow
from .scheduler import EngineOverloaded

__all__ = ["ServingHTTPServer"]


class ServingHTTPServer:
    """``slo_p99_ms`` / ``slo_error_rate`` make ``/healthz`` an SLO
    probe: over a rolling window of the last ``slo_window`` requests,
    a breached latency p99 or error rate flips the endpoint to 503 —
    the signal a load balancer needs to drain a degraded replica
    *before* users notice, instead of a liveness-only 200 that stays
    green while every request times out. With neither SLO configured
    ``/healthz`` keeps its plain-liveness behavior."""

    def __init__(self, backend, host="127.0.0.1", port=0, telemetry=None,
                 request_timeout_s=60.0, slo_p99_ms=None,
                 slo_error_rate=None, slo_window=128):
        self.backend = backend
        self.telemetry = _telemetry.resolve(telemetry)
        self.host = host
        self.port = int(port)
        self.request_timeout_s = float(request_timeout_s)
        self.slo_p99_ms = slo_p99_ms
        self.slo_error_rate = slo_error_rate
        # one shared breach definition with the replica router and the
        # decode engine (serving/router.py)
        self._slo = SLOWindow(slo_p99_ms, slo_error_rate, slo_window)
        self._httpd = None
        self._thread = None
        # the session backend is NOT thread-safe (shape inference writes
        # on shared graph nodes); ThreadingHTTPServer handlers must
        # single-flight it. The batcher backend serializes internally.
        self._backend_lock = threading.Lock()
        # does the backend's submit() take the tracing id? (engine,
        # batcher, router: yes; decided once, not per request)
        self._submit_takes_rid = False
        submit = getattr(backend, "submit", None)
        if callable(submit):
            try:
                params = inspect.signature(submit).parameters
                self._submit_takes_rid = "request_id" in params or any(
                    p.kind is inspect.Parameter.VAR_KEYWORD
                    for p in params.values())
            except (TypeError, ValueError):
                pass

    def _note_request(self, ok, ms):
        self._slo.note(ok, ms)

    def health(self):
        """(healthy, reason) under the configured SLOs."""
        return self._slo.health()

    # ------------------------------------------------------------------
    def _predict(self, inputs, request_id=None):
        feeds = {str(k): np.asarray(v) for k, v in inputs.items()}
        backend = self.backend
        if hasattr(backend, "submit"):      # batcher / engine / router
            if self._submit_takes_rid and request_id is not None:
                fut = backend.submit(feeds, request_id=request_id)
            else:
                fut = backend.submit(feeds)
            outs = fut.result(self.request_timeout_s)
        else:                                   # InferenceSession
            with self._backend_lock:
                outs = backend.predict(feeds)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        return [np.asarray(o).tolist() for o in outs]

    # ------------------------------------------------------------------
    def start(self):
        """Bind + serve on a daemon thread; returns the bound port."""
        server = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code, body, ctype="application/json",
                       rid=None, retry_after_s=None):
                data = body if isinstance(body, bytes) \
                    else json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                if rid is not None:
                    self.send_header("X-Request-Id", rid)
                if retry_after_s is not None:
                    self.send_header("Retry-After", str(retry_after_s))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):                           # noqa: N802
                path = self.path.rstrip("/")
                if path == "/healthz":
                    healthy, reason = server.health()
                    # healthy keeps the plain liveness body (pinned by
                    # tests); the breach reason rides the 503 only
                    self._reply(200 if healthy else 503,
                                {"ok": True} if healthy
                                else {"ok": False, "reason": reason})
                elif path == "/metrics":
                    tel = server.telemetry
                    if not tel.enabled:
                        self.send_error(404, "telemetry disabled")
                        return
                    self._reply(200, tel.metrics.to_prometheus().encode(),
                                ctype="text/plain; version=0.0.4")
                elif path == "/v1/requests":
                    fn = getattr(server.backend, "inflight_requests",
                                 None)
                    if not callable(fn):
                        self.send_error(
                            404, "backend has no in-flight introspection")
                        return
                    rows = fn()
                    self._reply(200, {"requests": rows,
                                      "count": len(rows)})
                elif path == "/stats":
                    healthy, reason = server.health()
                    body = {"healthy": healthy, "reason": reason,
                            "slo_p99_ms": server.slo_p99_ms,
                            "slo_error_rate": server.slo_error_rate}
                    fn = getattr(server.backend, "stats", None)
                    if callable(fn):
                        body["backend"] = fn()
                    self._reply(200, body)
                else:
                    self.send_error(404)

            def do_POST(self):                          # noqa: N802
                if self.path.rstrip("/") != "/v1/predict":
                    self.send_error(404)
                    return
                t0 = time.perf_counter()
                # ingress mints the end-to-end tracing id (or honors
                # the client's); EVERY reply below echoes it
                rid = self.headers.get("x-request-id") \
                    or mint_request_id()
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    inputs = req.get("inputs", {})
                    if not isinstance(inputs, dict):
                        raise ValueError(
                            '"inputs" must be an object of '
                            "{feed_name: nested_list}")
                    outs = server._predict(inputs, request_id=rid)
                except (ValueError, KeyError, TypeError) as e:
                    # client errors don't count against the error SLO
                    self._reply(400,
                                {"error": f"{type(e).__name__}: {e}",
                                 "request_id": rid}, rid=rid)
                    return
                except (EngineOverloaded, RouterOverloaded,
                        KVCacheExhausted) as e:
                    # backpressure, not breakage: 429 when THIS
                    # engine's queue shed us (retry here soon), 503
                    # when the fleet/pool can't take it (retry later,
                    # ideally elsewhere). Counts against the error SLO
                    # so a shedding replica drains out of the router
                    # rotation.
                    server._note_request(
                        False, (time.perf_counter() - t0) * 1e3)
                    code, retry_s = (429, 1) \
                        if isinstance(e, EngineOverloaded) else (503, 2)
                    if server.telemetry.enabled:
                        server.telemetry.inc("http_shed_requests")
                    self._reply(code,
                                {"error": f"{type(e).__name__}: {e}",
                                 "request_id": rid,
                                 "retry_after_ms": retry_s * 1000},
                                rid=rid, retry_after_s=retry_s)
                    return
                except Exception as e:                  # noqa: BLE001
                    server._note_request(
                        False, (time.perf_counter() - t0) * 1e3)
                    self._reply(500,
                                {"error": f"{type(e).__name__}: {e}",
                                 "request_id": rid}, rid=rid)
                    return
                ms = (time.perf_counter() - t0) * 1e3
                server._note_request(True, ms)
                if server.telemetry.enabled:
                    server.telemetry.observe("http_request_ms", ms)
                self._reply(200, {"outputs": outs,
                                  "latency_ms": round(ms, 3),
                                  "request_id": rid}, rid=rid)

            def log_message(self, *a):                  # quiet
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="serving-http")
        self._thread.start()
        return self.port

    def stop(self):
        """Stop the serve loop, JOIN the serving thread, then release the
        listening socket (a server reusing the port must not find it
        still held)."""
        if self._httpd is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._httpd.server_close()
            self._thread = None
            self._httpd = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
