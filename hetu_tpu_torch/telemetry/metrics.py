"""Metrics registry: counters, gauges, and streaming histograms with
p50/p95/p99, exportable as JSONL and as a Prometheus text-format scrape
(servable over HTTP — the PS server process and the launcher's
``--telemetry`` both expose it). Counterpart of
``hetu_tpu/telemetry/metrics.py``. It imports numpy and nothing of torch:
the PS server process, which has no torch, loads this file by its path.
"""
from __future__ import annotations

import json
import re
import sys
import threading
import time

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "stop_http_server"]


def stop_http_server(httpd, thread):
    """The one clean serve_forever teardown, shared by every HTTP
    surface (metrics scrape, graphboard, serving frontend): stop the
    serve loop, JOIN the serving thread (so thread-leak checks see it
    actually gone), then ``server_close()`` to release the listening
    socket — a second fleet reusing the port must not hit TIME_WAIT on
    a socket the old server still holds open."""
    httpd.shutdown()
    if thread is not None:
        thread.join()
    httpd.server_close()

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name):
    return _NAME_RE.sub("_", name)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "value")

    def __init__(self, name):
        self.name = name
        self.value = 0

    def inc(self, n=1):
        self.value += n

    def snapshot(self):
        return {"name": self.name, "type": "counter", "value": self.value}


class Gauge:
    """Last-value gauge; ``fn`` makes it computed at scrape time (e.g.
    process uptime on the PS server)."""

    __slots__ = ("name", "_value", "fn")

    def __init__(self, name, fn=None):
        self.name = name
        self._value = 0.0
        self.fn = fn

    def set(self, v):
        self._value = v

    @property
    def value(self):
        return self.fn() if self.fn is not None else self._value

    def snapshot(self):
        return {"name": self.name, "type": "gauge",
                "value": float(self.value)}


class Histogram:
    """Streaming histogram over a bounded recent-sample window.

    Keeps the last ``max_samples`` observations in a ring (plus running
    count/sum over everything ever observed); percentiles are computed
    over the window with numpy's default (linear-interpolation) method,
    so on samples smaller than the window they match ``np.percentile``
    exactly (tests/test_torch_telemetry.py pins this).
    """

    __slots__ = ("name", "count", "sum", "_ring", "_max")

    def __init__(self, name, max_samples=4096):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self._ring = []
        self._max = int(max_samples)

    def observe(self, v):
        v = float(v)
        if self.count < self._max:
            self._ring.append(v)
        else:
            self._ring[self.count % self._max] = v
        self.count += 1
        self.sum += v

    def percentile(self, q):
        if not self._ring:
            return 0.0
        return float(np.percentile(self._ring, q))

    def snapshot(self):
        out = {"name": self.name, "type": "histogram",
               "count": self.count, "sum": round(self.sum, 6)}
        if self._ring:
            arr = np.asarray(self._ring)
            out.update(
                p50=float(np.percentile(arr, 50)),
                p95=float(np.percentile(arr, 95)),
                p99=float(np.percentile(arr, 99)),
                min=float(arr.min()), max=float(arr.max()),
                mean=float(arr.mean()))
        return out


class MetricsRegistry:
    """Get-or-create registry of named metrics."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()
        self._server = None
        self._server_thread = None
        # optional callable returning a JSON-able dict served at /fleet
        # (the fleet StepTimeline installs its recent-window payload
        # here so the launcher's FleetMonitor can scrape it live)
        self.fleet_source = None

    def _get(self, name, cls, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {cls.__name__}")
            return m

    def counter(self, name):
        return self._get(name, Counter)

    def gauge(self, name, fn=None):
        g = self._get(name, Gauge)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name, max_samples=4096):
        return self._get(name, Histogram, max_samples=max_samples)

    def peek(self, name):
        """Current value of a metric if it exists, else None — a read
        that never creates (the fleet timeline samples PS gauges this
        way without registering them on ranks that have no PS)."""
        with self._lock:
            m = self._metrics.get(name)
        return getattr(m, "value", None)   # histograms have no scalar

    def names(self):
        """Registered metric names (snapshot)."""
        with self._lock:
            return list(self._metrics)

    @property
    def serving(self):
        """True while the HTTP scrape server is up."""
        return self._server is not None

    def snapshot(self):
        with self._lock:
            metrics = list(self._metrics.values())
        return [m.snapshot() for m in metrics]

    # -- exports ---------------------------------------------------------
    def to_jsonl(self):
        """One JSON line per metric."""
        return "\n".join(json.dumps(s) for s in self.snapshot())

    def dump_jsonl(self, path):
        with open(path, "w") as f:
            snap = self.to_jsonl()
            f.write(snap + ("\n" if snap else ""))
        return path

    def to_prometheus(self):
        """Prometheus text exposition format; histograms export as
        summaries (quantile series + _count/_sum)."""
        lines = []
        for s in self.snapshot():
            name = _prom_name(s["name"])
            if s["type"] in ("counter", "gauge"):
                lines.append(f"# TYPE {name} {s['type']}")
                lines.append(f"{name} {s['value']}")
            else:
                lines.append(f"# TYPE {name} summary")
                for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    if key in s:
                        lines.append(
                            f'{name}{{quantile="{q}"}} {s[key]}')
                lines.append(f"{name}_count {s['count']}")
                lines.append(f"{name}_sum {s['sum']}")
        return "\n".join(lines) + "\n"

    # -- HTTP scrape -----------------------------------------------------
    def serve(self, port, host="127.0.0.1", sock=None):
        """Serve ``/metrics`` (Prometheus text format) on a daemon
        thread; returns the bound port. ``sock``, a socket already
        bound and listening (a port claimed for this server), is served
        in place of binding ``(host, port)``."""
        import http.server

        registry = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _reply(self, body, ctype):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):                           # noqa: N802
                path = self.path.rstrip("/")
                if path == "/healthz":
                    self._reply(b'{"ok": true}', "application/json")
                elif path in ("", "/metrics"):
                    self._reply(registry.to_prometheus().encode(),
                                "text/plain; version=0.0.4")
                elif path == "/fleet":
                    src = registry.fleet_source
                    if src is None:
                        self.send_error(404)
                    else:
                        try:
                            body = json.dumps(src()).encode()
                        except Exception:
                            self.send_error(500)
                            return
                        self._reply(body, "application/json")
                else:
                    self.send_error(404)

            def log_message(self, *a):                  # quiet
                pass

        class Server(http.server.ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # a scraper that gave up and closed its end (the fleet
                # monitor's short timeout while a step holds the rank's
                # interpreter) is no error of the server's
                if isinstance(sys.exc_info()[1], ConnectionError):
                    return
                super().handle_error(request, client_address)

        if sock is None:
            self._server = Server((host, port), Handler)
        else:
            self._server = Server(sock.getsockname(), Handler,
                                  bind_and_activate=False)
            self._server.socket.close()
            self._server.socket = sock
        self._server_thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="metrics-scrape")
        self._server_thread.start()
        return self._server.server_address[1]

    def shutdown(self):
        """Stop the scrape server cleanly (:func:`stop_http_server`);
        close() kept as an alias for existing callers."""
        if self._server is not None:
            stop_http_server(self._server, self._server_thread)
            self._server_thread = None
            self._server = None

    def close(self):
        self.shutdown()


def uptime_gauge(registry, name="process_uptime_seconds"):
    """Scrape-time uptime gauge (PS server liveness)."""
    t0 = time.time()
    return registry.gauge(name, fn=lambda: time.time() - t0)
